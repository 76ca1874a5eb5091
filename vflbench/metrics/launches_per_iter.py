"""Engine and limb glue: device kernels an iteration (copies and sets
not counted)."""


def read(v):
    if not v.has_device or v.launches == 0:
        return None
    return v.per_iter(v.launches)
