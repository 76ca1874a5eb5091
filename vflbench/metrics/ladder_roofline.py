"""Kernels, ladder class: the least time of the iteration's modular
exponentiations (r^n noise, mask noise, CRT-decrypt ladders), counted
from the protocol's shapes, over the device time of the class's kernels."""


def read(v):
    dev = v.class_s.get("ladder", 0.0)
    if dev <= 0:
        return None
    return 100.0 * v.work.seconds["ladder"] * v.iters / dev
