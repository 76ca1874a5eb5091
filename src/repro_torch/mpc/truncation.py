"""Fixed-point truncation on Z_2^64 shares (SecureML §4.1, local).

After a fixed-point product the value carries 2f fractional bits; each
party truncates its own share:
  P0: ⟨x⟩_0' = ⌊⟨x⟩_0 / 2^f⌋
  P1: ⟨x⟩_1' = 2^64 − ⌊(2^64 − ⟨x⟩_1) / 2^f⌋
With |x| < 2^ℓ the result equals ⌊x/2^f⌋ ± 1 except with probability
2^{ℓ+1−64} (error event: the shares straddle the wrap point).  ℓ ≤ 45 in
our protocols → failure ≤ 2^−18 per element per step; the end-to-end GLM
tests bound the induced noise empirically.
"""
from __future__ import annotations

from repro_torch.crypto import ring
from repro_torch.crypto.ring import R64


def trunc_share(x: R64, f: int, party: int) -> R64:
    if f == 0:
        return x
    if party == 0:
        return ring.shift_right_logical(x, f)
    neg = ring.neg(x)
    return ring.neg(ring.shift_right_logical(neg, f))


def trunc_pair(x0: R64, x1: R64, f: int) -> tuple[R64, R64]:
    return trunc_share(x0, f, 0), trunc_share(x1, f, 1)
