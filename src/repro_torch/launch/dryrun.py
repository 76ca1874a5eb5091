"""The H100 hardware model and the measurement helpers of the dry-runs.

The counterparts of the reference's `launch/dryrun.py` helpers: its v5e
constants become an H100's, `peak_bytes` (XLA's compiled memory
analysis) becomes the allocator's peak, and `parse_collectives` (the
HLO census) becomes a report of the collectives the ranks really called
(`distributed.secure_ops.stats`).  The rest of the reference module (the
LM architectures' dry-run) is not ported here.
"""
from __future__ import annotations

import torch

#: the card these constants describe, as
#: ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
#: prints it
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
#: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
#: int32 operations/s on the CUDA cores (the Montgomery products' type)
INT32_OPS = 16.7e12
#: int8 tensor-core operations/s (dense)
INT8_TC_OPS = 1979e12
#: NVLink bandwidth, bytes/s in each direction: the datasheet's 900 GB/s
#: counted one way
NVLINK_BW = 450e9


def roofline_terms(flops_per_dev: float, hbm_bytes_per_dev: float,
                   coll_bytes_per_dev: float) -> dict:
    """The reference's three roofline terms, in seconds, over the H100's
    int32 rate (a Montgomery product's word operations), HBM bandwidth
    and NVLink bandwidth."""
    return {
        "compute_s": flops_per_dev / INT32_OPS,
        "memory_s": hbm_bytes_per_dev / HBM_BW,
        "collective_s": coll_bytes_per_dev / NVLINK_BW,
    }


def peak_bytes(device) -> int | None:
    """The allocator's peak on `device` since its last reset
    (`torch.cuda.max_memory_allocated`); None on the CPU, which keeps no
    such count."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def collectives_report(stats) -> dict:
    """Bytes sent by kind, their total, and the calls by kind, in the
    shape of the reference's `parse_collectives`, from a
    `secure_ops.CollectiveStats`.  The kinds are the port's collectives:
    ``exchange`` (the ⊕-butterfly's pairwise hop), ``all_reduce`` and
    ``all_gather``."""
    out: dict = {k: float(v) for k, v in sorted(stats.bytes.items())}
    out["total_bytes"] = float(sum(stats.bytes.values()))
    out["op_counts"] = dict(sorted(stats.calls.items()))
    return out
