"""Sizes at which the CPU tests drive each cell: the same configurations
and traffic kinds, tiny films and scenes (a still's CPU step takes seconds,
so its early check reads the first step)."""

TINY = {
    "heightfield_anim.video": {
        "params": {"n": 16},
        "traffic": {"width": 32, "height": 24, "check_pixels": 64}},
    "courtyard.still": {
        "params": {"detail": 0.1, "tex_scale": 0.0625},
        "traffic": {"width": 16, "height": 12, "early_steps": 1,
                    "early_pixels": 128, "check_pixels": 64}},
}
