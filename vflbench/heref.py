"""Plain NumPy reference of the Paillier layer's Protocol-3 outputs.

A masked matvec leg encrypts a share vector d in Z_2^64, raises the
ciphertexts to the feature owner's offset-lifted fixed-point exponents,
multiplies the columns together, adds the mask R and decrypts.  Every
plaintext stays below n, so the decrypted value reduced mod 2^64 is
exactly (sum_i e_ij d_i + R_j) mod 2^64: uint64 arithmetic wraps there.
"""
from __future__ import annotations

import numpy as np


def encode_exps(x: np.ndarray, fx: int, width: int) -> np.ndarray:
    """Offset-lifted fixed-point exponents rint(x 2^fx) + 2^(width - 1)."""
    xi = np.rint(np.asarray(x, np.float64) * (1 << fx)).astype(np.int64)
    return (xi + (1 << (width - 1))).astype(np.uint64)


def masked_leg(exps: np.ndarray, d: np.ndarray, masks) -> np.ndarray:
    """(sum_i exps[i, j] d[i] + R_j) mod 2^64 for every column j."""
    with np.errstate(over="ignore"):
        s = (exps.astype(np.uint64) * d.astype(np.uint64)[:, None]).sum(
            axis=0, dtype=np.uint64)
        r = np.array([int(v) % (1 << 64) for v in masks], np.uint64)
        return s + r
