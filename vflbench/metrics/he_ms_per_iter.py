"""Paillier backend: host time inside the benchmark's spans around
encrypt_share, matvec, add_mask and decrypt_to_r64, read from the
profiler's trace (the spans add no synchronisation), in ms an
iteration."""


def read(v):
    if v.he_span_s is None or v.he_span_s <= 0:
        return None
    return 1e3 * v.per_iter(v.he_span_s)
