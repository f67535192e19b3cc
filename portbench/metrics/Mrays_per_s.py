"""Mrays_per_s (Mrays/s), and `Mrays_per_s.video`: useful rays a second
of the renderer's loop: `Renderer.rays_traced`, read after each step or
frame before the film's next reset, over those steps' time (the traced
run's steps outside its profiled sub-window)."""


def read(run):
    seconds = sum(s for _, s in run.rays)
    if not run.rays or seconds <= 0:
        return None
    return sum(n for n, _ in run.rays) / seconds / 1e6
