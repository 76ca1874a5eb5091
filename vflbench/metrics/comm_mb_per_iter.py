"""Scheduler and protocols: bytes the parties send an iteration over the
run's window, from the transport's CommMeter, in MB (10^6 bytes)."""


def read(v):
    return v.comm_mb_per_iter if v.comm_mb_per_iter > 0 else None
