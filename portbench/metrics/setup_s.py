"""setup_s (s): process start to the first timed step's start: imports,
the scene inputs (generated on a checkout's first run, then loaded), the
scene build, texture pool and accel, kernel builds on a first run, and the
warm-up."""


def read(run):
    return run.setup_s or None
