"""The benchmark's wrapper around the program's HE backend.

It forwards every call.  Two switches add to that:

* `spans`: each of the four Protocol-3 calls (`encrypt_share`, `matvec`,
  `add_mask`, `decrypt_to_r64`) runs inside a
  `torch.profiler.record_function("he.<call>")`, and nothing else: no
  synchronisation is added, so the traced iterations keep the program's
  own schedule.  The profiler's trace holds the spans' intervals.
* `capture`: the calls' inputs and outputs are kept, so that each
  decrypted masked value can be paired with the share, exponents and
  mask it came from (`legs`), and each encrypted share with its key
  owner (`shares`).
"""
from __future__ import annotations

import numpy as np

SPAN_PREFIX = "he."


def r64_to_u64(x) -> np.ndarray:
    """An R64 (32-bit halves held in int64 tensors) as uint64 values."""
    hi = x.hi.detach().cpu().numpy().astype(np.uint64)
    lo = x.lo.detach().cpu().numpy().astype(np.uint64)
    return (hi << np.uint64(32)) | lo


class TracedBackend:
    def __init__(self, inner):
        self._inner = inner
        self.spans = False
        self.capture = False
        self._reset_capture()

    def __getattr__(self, name):
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)

    def _reset_capture(self) -> None:
        self._enc, self._mv, self._add, self._dec = {}, {}, {}, []

    def _call(self, op: str, *args):
        fn = getattr(self._inner, op)
        if not self.spans:
            out = fn(*args)
        else:
            from torch.profiler import record_function
            with record_function(SPAN_PREFIX + op):
                out = fn(*args)
        if self.capture:
            self._record(op, args, out)
        return out

    def _record(self, op: str, args, out) -> None:
        # the output objects are kept too, so no id is reused meanwhile
        if op == "encrypt_share":
            self._enc[id(out)] = (out, r64_to_u64(args[1]), args[0])
        elif op == "matvec":
            party, cts, exps = args[:3]
            self._mv[id(out)] = (out, id(cts),
                                 np.array(exps, np.uint64), party)
        elif op == "add_mask":
            self._add[id(out)] = (out, id(args[1]), list(args[2]))
        else:
            self._dec.append((id(args[1]), r64_to_u64(out), args[0]))

    def take(self) -> tuple[list, list]:
        """(legs, shares) captured since the last call.  Legs: (key owner,
        exps, d, masks, decrypted) with uint64 arrays; a decrypted value
        whose inputs were not all seen gives None for them.  Shares: (key
        owner, d) of each `encrypt_share`, in call order."""
        shares = [(owner, d) for _, d, owner in self._enc.values()]
        out = []
        for ct_id, dec, owner in self._dec:
            add = self._add.get(ct_id)
            mv = self._mv.get(add[1]) if add else None
            enc = self._enc.get(mv[1]) if mv else None
            out.append((owner, mv[2] if mv else None,
                        enc[1] if enc else None,
                        add[2] if add else None, dec))
        self._reset_capture()
        return out, shares

    # the four Protocol-3 calls
    def encrypt_share(self, party, d):
        return self._call("encrypt_share", party, d)

    def matvec(self, party, cts, exps, width, digits=None):
        return self._call("matvec", party, cts, exps, width, digits)

    def add_mask(self, party, cts, mask_ints):
        return self._call("add_mask", party, cts, mask_ints)

    def decrypt_to_r64(self, party, cts):
        return self._call("decrypt_to_r64", party, cts)
