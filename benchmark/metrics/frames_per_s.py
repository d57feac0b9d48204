"""Valid frames of the requests completed inside the window, over the window's whole time."""

from benchmark import window


def read(run):
    return window.frames_per_s(run.done, run.t0, run.t1)
