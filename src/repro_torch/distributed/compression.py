"""Lossless wire frame deflation for the EFMVFL socket link.

The wire half of the reference's `distributed/compression.py`: the only
compression admissible on the socket wire is lossless (zlib), because
the protocol's bit-exactness guarantee (losses, weights, per-tag bytes
identical across transports) would not survive quantization.
`validate_wire_scheme` is the gate — the lossy scheme is refused BY
NAME, never silently accepted.  `worth_deflating` is a deterministic
probe (first 4 KiB at level 1): entropy-dense Paillier/ring payloads are
skipped without paying full-frame compression, while zero-padded mock
ciphertexts and JSON control frames compress well.  The chaos link layer
(`runtime.chaos`) applies these BELOW the metering boundary, so analytic
== measured accounting is untouched; actual wire savings are reported in
`ChaosStats`.  zlib at a fixed level gives the same bytes for the same
input in both packages, so a mixed cluster's peers inflate each other's
frames.

Not ported yet: the lossy int8 error-feedback half (`compress`,
`decompress`, `init_error`, `wire_bytes`), which serves the language
model side's data-parallel gradients (ROADMAP Queue 1 item 8), not the
wire.
"""
from __future__ import annotations

import zlib

#: schemes admissible on the socket wire — lossless only
WIRE_SCHEMES = ("none", "zlib")

#: deflate level for wire frames (speed-leaning; the probe already
#: filtered out incompressible payloads)
_WIRE_LEVEL = 6

#: probe: compress the first `_PROBE_BYTES` at level 1; deflate the
#: whole frame only when the probe shrinks below `_PROBE_RATIO`
_PROBE_BYTES = 4096
_PROBE_RATIO = 0.9


def validate_wire_scheme(name: str) -> str:
    """Refuse silently-lossy wire paths: only bit-exact schemes pass.
    The int8/EF path exists for DP gradients and must never be routed
    onto the protocol wire."""
    if name in WIRE_SCHEMES:
        return name
    if name == "int8":
        raise ValueError(
            "wire_compression='int8' refused: int8 error-feedback "
            "quantization is LOSSY — the socket wire requires bit-exact "
            f"frames (choose one of {WIRE_SCHEMES})")
    raise ValueError(f"unknown wire_compression {name!r} "
                     f"(choose one of {WIRE_SCHEMES})")


def worth_deflating(frame: bytes, probe_bytes: int = _PROBE_BYTES,
                    ratio: float = _PROBE_RATIO) -> bool:
    """Deterministic cheap decision: is this frame compressible enough
    to bother?  Pure function of the frame bytes — both link endpoints
    and any replay reach the same verdict."""
    if len(frame) < 64:                 # tiny frames: header dominates
        return False
    head = frame[:probe_bytes]
    return len(zlib.compress(head, 1)) < ratio * len(head)


def deflate_frame(frame: bytes) -> bytes:
    """Losslessly deflate one codec frame for the wire."""
    return zlib.compress(frame, _WIRE_LEVEL)


def inflate_frame(body: bytes) -> bytes:
    """Exact inverse of `deflate_frame` (zlib is bit-exact by
    construction; the link envelope's crc32 additionally guards the
    compressed body in transit)."""
    return zlib.decompress(body)
