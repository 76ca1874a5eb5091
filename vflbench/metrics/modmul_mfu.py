"""The whole step: the least time of all the iteration's modular
products (ladders, matvecs, encryption products, masking, CRT), counted
from the protocol's shapes, over the iteration's wall time in the run's
untraced window: a share of the card's integer peak."""


def read(v):
    if not v.has_device:
        return None
    return 100.0 * v.work.total_s / v.s_per_iter
