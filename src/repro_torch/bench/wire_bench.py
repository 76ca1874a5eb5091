"""Codec throughput bench: encode/decode rates of the wire formats — the
reference's `benchmarks/wire_bench.py` rows and sizes, on the port, plus
one paper-width row.

Rows cover the hot frame classes of a training iteration: ring-share
frames (8-byte LE elements), mock ciphertext frames (canonical-width
padding), and real Paillier ciphertext frames (Montgomery → canonical →
Montgomery, the expensive direction: the codec's `from_mont` / `to_mont`
run on the ciphertexts' device).  The paper-width row is the `EncD`
Table 1 sends every iteration: 2048 ciphertexts under a 1024-bit key,
encoded and decoded on `device` (on the card, K1 at (2048, 329)).  Every
decode is held equal to the message encoded; times are host wall clock
per call, synchronised.

    python -m repro_torch.bench.run --only wire [--smoke] [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.crypto import engine as engine_mod
from repro_torch.crypto import fixed_point, paillier, ring
from repro_torch.runtime import messages as msg
from repro_torch.runtime.codec import Codec


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _time(fn, reps: int, device) -> float:
    fn()                                       # warm-up
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / reps * 1e6


def _row(name: str, us: float, payload_bytes: int, reps: int,
         device) -> dict:
    return {
        "name": name,
        "us": us,
        "payload_bytes": payload_bytes,
        "mb_per_s": payload_bytes / max(us, 1e-9),
        "reps": reps,
        "device": str(device),
        "derived": f"payload_b={payload_bytes};"
                   f"mbps={payload_bytes / max(us, 1e-9):.1f}",
    }


def _same(a, b) -> bool:
    if isinstance(a, ring.R64):
        return bool(np.array_equal(ring.to_numpy_u64(a),
                                   ring.to_numpy_u64(b)))
    return bool(torch.equal(a.cpu(), b.cpu()))


def _rows_of(base: str, sizes: str, m: msg.Message, codec: Codec,
             reps: int, device) -> list[dict]:
    """`{base}_encode{sizes}` and `{base}_decode{sizes}`, the decode held
    equal to `m`."""
    frame = codec.encode(m)
    if not _same(codec.decode(frame).payload, m.payload):
        raise RuntimeError(f"{base}{sizes}: decode(encode(m)) differs "
                           "from m")
    n = int(m.wire_bytes())
    return [_row(f"{base}_encode{sizes}",
                 _time(lambda: codec.encode(m), reps, device), n, reps,
                 device),
            _row(f"{base}_decode{sizes}",
                 _time(lambda: codec.decode(frame), reps, device), n, reps,
                 device)]


def _paillier_rows(base: str, cls, n_cts: int, key_bits: int, reps: int,
                   rng, device) -> list[dict]:
    pub = paillier.keygen(key_bits, seed=7).pub
    vals = ring.from_numpy_u64(
        rng.integers(0, 1 << 64, n_cts, dtype=np.uint64), device)
    cts = paillier.encrypt(pub, fixed_point.r64_to_limbs(vals, pub.Ln),
                           engine_mod.make(), rng=rng)
    codec = Codec(lambda owner: pub.mod_n2, device=device)
    m = cls("B1", "C", cts, n_cts=n_cts, key_bits=key_bits, key_owner="C")
    return _rows_of(base, f".n{n_cts}.k{key_bits}", m, codec, reps, device)


def run(smoke: bool = False, device: str = "cuda") -> list[dict]:
    rng = np.random.default_rng(0)
    nb = 128 if smoke else 2048
    m = 8 if smoke else 64
    key_bits = 192 if smoke else 256
    reps = 3 if smoke else 20
    rows: list[dict] = []
    codec = Codec(device=device)

    # -- ring share frames (Protocol 1 / Beaver openings) -----------------
    v = ring.from_numpy_u64(rng.integers(0, 1 << 64, nb, dtype=np.uint64),
                            device)
    rows += _rows_of("wire.ring", f".n{nb}", msg.ZShare("B1", "C", v),
                     codec, reps, device)
    # -- mock ciphertext frames (canonical-width padding) -----------------
    rows += _rows_of("wire.mock_ct", f".n{nb}.k{key_bits}",
                     msg.EncD("C", "B1", v, n_cts=nb, key_bits=key_bits,
                              key_owner="C"), codec, reps, device)
    # -- real Paillier ciphertext frames ----------------------------------
    rows += _paillier_rows("wire.paillier_ct", msg.MaskedGrad, m, key_bits,
                           max(2, reps // 4), rng, device)
    # -- the paper's width: Table 1's [[<d>]], 2048 cts, 1024-bit key -----
    if not smoke:
        rows += _paillier_rows("wire.paper_enc_d", msg.EncD, 2048, 1024, 5,
                               rng, device)
    return rows
