"""Engine and limb glue: device time of every kernel that no operation
class lists, in ms an iteration."""


def read(v):
    if not v.has_device:
        return None
    return 1e3 * v.per_iter(v.glue_s)
