"""Hand keys and tables over from the JAX package, as plain
integers and numpy arrays (this module imports neither package's
arrays: callers pass the reference objects' fields).

* `keys_from_numpy` builds the port's `PrivateKey` from the primes and
  checks every numpy field it is given against the derived one.
* `table_from_numpy` builds the port's `FixedBaseTable` from a reference
  table's payload and identity fields, checking its header.
"""
from __future__ import annotations

import numpy as np

from repro_torch.crypto import fixed_base, paillier


def keys_from_numpy(p: int, q: int, key_bits: int,
                    **fields: np.ndarray) -> paillier.PrivateKey:
    """The port's keypair for primes p, q.  Any of the PrivateKey's numpy
    fields passed by name (`lam_bits`, `mu_mont`, `hensel_n`,
    `q_pinv_mont`) must equal the derived value; a mismatch raises."""
    key = paillier.key_from_primes(int(p), int(q), int(key_bits))
    for name, want in fields.items():
        have = getattr(key, name)
        if not np.array_equal(np.asarray(want), have):
            raise ValueError(f"key field {name!r} differs from the value "
                             "derived from p and q")
    return key


def table_from_numpy(table_rns: np.ndarray, *, purpose: str, n: int,
                     base: int, window: int, levels: int, L: int,
                     header: dict | None = None
                     ) -> fixed_base.FixedBaseTable:
    """The port's fixed-base table from a reference table's `table_rns`
    payload and fields.  A reference `header()` passed along must equal
    the port table's own header; a mismatch raises
    `fixed_base.TableMismatchError`."""
    table = fixed_base.FixedBaseTable(
        purpose=purpose, n=int(n), base=int(base), window=int(window),
        levels=int(levels), L=int(L),
        table_rns=np.asarray(table_rns, np.uint32))
    if header is not None and dict(header) != table.header():
        raise fixed_base.TableMismatchError(
            f"table header {dict(header)} differs from {table.header()}")
    return table
