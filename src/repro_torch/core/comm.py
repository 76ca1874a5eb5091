"""Communication metering — reproduces the paper's `comm` columns.

Every protocol send is routed through a CommMeter; sizes use the wire
format a real deployment serializes (8-byte ring elements, canonical
2*key_bits-bit Paillier ciphertexts, 1-byte flags).
"""
from __future__ import annotations

import collections
import dataclasses

RING_BYTES = 8
FLAG_BYTES = 1


def ciphertext_wire_bytes(key_bits: int) -> int:
    """Serialized size of ONE canonical Z_{n²} ciphertext: ⌈2·key_bits/8⌉.
    The single source of truth — `runtime.messages`, the meter helper
    below, and `crypto.paillier` all delegate here so the analytic
    accounting can never disagree with what `runtime.codec` frames."""
    return (2 * key_bits + 7) // 8


@dataclasses.dataclass
class Send:
    src: str
    dst: str
    tag: str
    nbytes: int


class CommMeter:
    def __init__(self) -> None:
        self.sends: list[Send] = []
        self.by_tag: dict[str, int] = collections.defaultdict(int)

    def add(self, src: str, dst: str, tag: str, nbytes: int) -> None:
        self.sends.append(Send(src, dst, tag, int(nbytes)))
        self.by_tag[tag] += int(nbytes)

    def ring(self, src: str, dst: str, tag: str, n_elems: int) -> None:
        self.add(src, dst, tag, n_elems * RING_BYTES)

    def cipher(self, src: str, dst: str, tag: str, n_cts: int,
               key_bits: int) -> None:
        self.add(src, dst, tag, n_cts * ciphertext_wire_bytes(key_bits))

    @property
    def total_bytes(self) -> int:
        return sum(s.nbytes for s in self.sends)

    @property
    def total_mb(self) -> float:
        return self.total_bytes / 1e6

    def summary(self) -> dict[str, float]:
        out = {k: v / 1e6 for k, v in sorted(self.by_tag.items())}
        out["TOTAL_MB"] = self.total_mb
        return out
