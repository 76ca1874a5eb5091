"""Compression: lossy int8 gradients (data-parallel) and lossless wire
frame deflation (the EFMVFL socket link).

Two regimes with opposite contracts:

* int8 + error feedback (`compress`/`decompress`) — LOSSY.  For the
  language-model side's data-parallel gradients: `compress` quantizes
  grad + error to int8 with a per-tensor scale, `decompress` restores
  float, and the residual carries to the next step.  Trees are
  ``{name: tensor}`` dicts (a module's named gradients).  The float32
  order of operations is the reference's and `torch.round` rounds half
  to even as `jnp.round` does, so `q`, the scales and the new error
  equal the reference's bit for bit.
* wire frame deflation — LOSSLESS (zlib), the only compression
  admissible on the socket wire, because the protocol's bit-exactness
  guarantee (losses, weights, per-tag bytes identical across
  transports) would not survive quantization.  `validate_wire_scheme` is the gate — the lossy scheme is refused BY
NAME, never silently accepted.  `worth_deflating` is a deterministic
probe (first 4 KiB at level 1): entropy-dense Paillier/ring payloads are
skipped without paying full-frame compression, while zero-padded mock
ciphertexts and JSON control frames compress well.  The chaos link layer
(`runtime.chaos`) applies these BELOW the metering boundary, so analytic
== measured accounting is untouched; actual wire savings are reported in
`ChaosStats`.  zlib at a fixed level gives the same bytes for the same
input in both packages, so a mixed cluster's peers inflate each other's
frames.
"""
from __future__ import annotations

import zlib

import torch

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


def init_error(params: dict) -> dict:
    """Zero float32 error buffers shaped as `params`, on their devices."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


@torch.no_grad()
def compress(grads: dict, error: dict):
    """-> (q int8 dict, scales dict of f32 scalars, new_error dict)."""
    q, s, e = {}, {}, {}
    for k, g in grads.items():
        gf = g.float() + error[k]
        # a 0-d tensor divisor: CUDA turns a Python scalar divisor into a
        # product with its reciprocal, one rounding off true division
        q_max = torch.full((), 127.0, device=gf.device)
        scale = torch.clamp(torch.amax(torch.abs(gf)), min=1e-12) / q_max
        q[k] = torch.clamp(torch.round(gf / scale), -127, 127
                           ).to(torch.int8)
        s[k] = scale
        e[k] = gf - q[k].float() * scale
    return q, s, e


@torch.no_grad()
def decompress(q: dict, scales: dict, dtype=torch.float32) -> dict:
    return {k: (qi.float() * scales[k]).to(dtype) for k, qi in q.items()}


def wire_bytes(tree: dict) -> int:
    """Bytes on the wire for a compressed gradient exchange."""
    return sum(x.numel() * x.element_size() for x in tree.values())
