"""Hand keys and tables over from the JAX package, as plain
integers and numpy arrays (this module imports neither package's
arrays: callers pass the reference objects' fields).

* `keys_from_numpy` builds the port's `PrivateKey` from the primes and
  checks every numpy field it is given against the derived one.
* `table_from_numpy` builds the port's `FixedBaseTable` from a reference
  table's payload and identity fields, checking its header.
* `lm_params_from_numpy` builds the port's model of any LM family from
  the reference's `init_params` tree as nested dicts (and lists) of
  numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.crypto import fixed_base, paillier
from repro_torch.models import registry

#: the port's module lists that hold the reference's stacked layer axis,
#: by the tree key of the stack
STACKED = {"blocks": "layers", "enc_blocks": "enc_layers",
           "dec_blocks": "dec_layers"}


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


def lm_params_from_numpy(cfg, tree: dict, device="cuda"):
    """The port's model for `cfg` (`registry.build(cfg)`'s: a
    `Transformer`, `RWKV6`, `Zamba2` or `Whisper`) holding the weights of
    a reference `init_params` tree: nested dicts of numpy arrays, bf16
    leaves passed as float32 (an exact upcast), zamba2's ``shared`` a
    list of two dicts.  Each stacked L axis (``layers``, whisper's
    ``enc_layers`` / ``dec_layers``) is split into the port's blocks
    (`STACKED`) and each weight cast back to its dtype in the port.
    Every leaf must be used and every shape must match; otherwise a
    `ValueError` is raised."""
    model = registry.build(cfg).init_params(None, device="meta")
    model = model.to_empty(device=device)
    used = set()

    def leaf(path):
        node = tree
        for key in path:
            if isinstance(node, (list, tuple)) and key.isdigit() \
                    and int(key) < len(node):
                node = node[int(key)]
            elif isinstance(node, dict) and key in node:
                node = node[key]
            else:
                raise ValueError(f"tree has no leaf {'/'.join(path)}")
        if isinstance(node, (dict, list, tuple)):
            raise ValueError(f"tree has no leaf {'/'.join(path)}")
        used.add(tuple(path))
        return np.asarray(node)

    with torch.no_grad():
        for name, param in model.named_parameters():
            parts = name.split(".")
            if parts[0] in STACKED:
                stack = leaf([STACKED[parts[0]]] + parts[2:])
                n = len(getattr(model, parts[0]))
                if stack.shape[:1] != (n,):
                    raise ValueError(f"{name}: {stack.shape[:1]} layers in "
                                     f"the tree, {n} in the port")
                arr = stack[int(parts[1])]
            else:
                arr = leaf(parts)
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"{name}: shape {arr.shape} in the tree, "
                                 f"{tuple(param.shape)} in the port")
            param.copy_(torch.tensor(arr))

    def paths(node, prefix=()):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from paths(v, prefix + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                yield from paths(v, prefix + (str(i),))
        else:
            yield prefix
    extra = set(paths(tree)) - used
    if extra:
        raise ValueError(f"tree leaves the port has no parameter for: "
                         f"{sorted('/'.join(p) for p in extra)}")
    return model
