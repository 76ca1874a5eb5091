"""Scheduler and protocols: the traced window's time outside the
benchmark's four Paillier spans, both read from the profiler's trace, in
ms an iteration."""


def read(v):
    if v.he_span_s is None or v.he_span_s <= 0:
        return None
    return 1e3 * v.per_iter(v.window_s - v.he_span_s)
