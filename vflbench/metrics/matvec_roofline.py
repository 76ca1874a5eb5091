"""Kernels, matvec class: the least time of the iteration's windowed HE
matvecs over the device time of the class's kernels."""


def read(v):
    dev = v.class_s.get("matvec", 0.0)
    if dev <= 0:
        return None
    return 100.0 * v.work.seconds["matvec"] * v.iters / dev
