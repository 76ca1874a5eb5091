"""Device: share of the traced window with nothing on the device, from
the union of device intervals on the timeline."""


def read(v):
    if not v.has_device or v.window_s <= 0:
        return None
    return 100.0 * (1.0 - v.busy_s / v.window_s)
