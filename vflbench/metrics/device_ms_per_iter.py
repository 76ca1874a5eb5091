"""Device: the traced iterations' device busy time (the union of device
intervals on the timeline) in ms an iteration.  A steadier companion of
s_per_iter, which the host's speed moves from run to run."""


def read(v):
    if not v.has_device or v.busy_s <= 0:
        return None
    return 1e3 * v.per_iter(v.busy_s)
