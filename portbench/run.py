"""The port's benchmark: run one cell of `BENCHMARK.json` and print its
result line. See `portbench/lib/main.py` for the command and the result."""

import time

T_PROCESS = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if sys.path and pathlib.Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))

from portbench.lib.cachedirs import cache_environment  # noqa: E402

if __name__ == "__main__":
    cache_environment()
    from portbench.lib.main import entry
    entry(T_PROCESS)
