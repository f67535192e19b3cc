"""The control on the card, at each cell's own size (marker `gpu`; it skips
without a card): on three seeds a short window of the program reads at or
below each limit, and the reference in bfloat16 storage reads above one of
them. Run on a card with
`python -m pytest portbench/tests/test_portbench_control.py -m gpu`."""

import io

import pytest
import torch

from portbench.reference.compare import load_limits


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["courtyard.still",
                                  "heightfield_anim.video"])
def test_control_fails_and_program_passes_at_cell_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench.readings import readings
    limits = load_limits(cell)
    rows = readings(cell, [2600000001, 2600000002, 2600000003], 10.0,
                    out=io.StringIO())
    for row in rows:
        for name, limit in limits.items():
            assert row["program"][name] <= limit, (row["seed"], name)
        assert any(row["control"][name] > limit
                   for name, limit in limits.items()), row["seed"]
