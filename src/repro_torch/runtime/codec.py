"""Versioned binary wire codec for the party-runtime messages.

Every typed envelope in `runtime.messages` has one frame encoding,
byte for byte the reference codec's (codec version 1):

    offset  size  field
    0       3     magic  b"EFM"
    3       1     codec version (currently 1)
    4       4     u32 LE header length H
    8       8     u64 LE payload length P
    16      4     u32 LE CRC-32 over header + payload
    20      H     header (type tag + routing + payload metadata)
    20+H    P     payload

The payload is the canonical serialization `Message.wire_bytes()`
accounts (the paper's comm columns count payloads; prelude and header
bytes are deployment overhead, reported apart by `SocketTransport`):

* ring tensors (`R64`) — 8-byte little-endian elements;
* float64 tensors (serving scores) — 8-byte little-endian elements;
* Paillier ciphertexts — canonical Z_{n²} residues, each packed into
  ⌈2·key_bits/8⌉ little-endian bytes.  In memory ciphertexts live in the
  Montgomery domain; the codec leaves and re-enters it with the crypto
  engine's `from_mont` / `to_mont` on the tensor's own device (K1, the
  RNS product, for n² of 512 bits and more on the card; K5 below; their
  plain versions on the CPU).  Both return the unique canonical residue,
  so the bytes are the reference's;
* mock-backend "ciphertexts" (ring values standing in for ciphertexts)
  — each 64-bit value zero-padded to the same canonical width, so the
  mock backend's measured bytes equal the real backend's;
* stop flags — one byte;
* control frames (`messages.Control`) — UTF-8 JSON.

`encode` refuses a frame whose payload length disagrees with the
message's own `wire_bytes()`; `decode` rejects truncated frames, bad
magic, unknown versions and types, CRC mismatches, residues ≥ n² and
non-zero mock padding with `CodecError`.

Real-Paillier ciphertext frames need the key owner's modulus, so a
`Codec` is built with the local party's view of the keys
(`key_provider`); ring, float, flag and control frames need no context
and work with `Codec()`.  Decoded tensors are placed on `device`.
"""
from __future__ import annotations

import json
import struct
import zlib

import numpy as np
import torch

from repro_torch.core.comm import ciphertext_wire_bytes
from repro_torch.crypto import bigint, ring
from repro_torch.crypto import engine as engine_mod
from repro_torch.crypto.ring import R64
from repro_torch.runtime import messages as msg

MAGIC = b"EFM"
VERSION = 1
PRELUDE = struct.Struct("<3sBIQI")      # magic, version, H, P, crc
assert PRELUDE.size == 20

# payload kinds ------------------------------------------------------------
PK_NONE = 0          # synthetic traffic (byte accounting only)
PK_R64 = 1           # ring tensor, 8-byte LE elements
PK_F64 = 2           # float64 tensor, 8-byte LE elements
PK_CT = 3            # canonical Z_{n²} ciphertexts (Montgomery in memory)
PK_CT_MOCK = 4       # mock ciphertext: u64 zero-padded to canonical width
PK_FLAG = 5          # one stop byte
PK_JSON = 6          # control frame

#: stable type-id registry (the reference's order) — appending is fine,
#: renumbering is a version bump
MESSAGE_TYPES: list[type[msg.Message]] = [
    msg.ZShare, msg.YShare, msg.EzShare, msg.BeaverOpen,
    msg.UnmaskedShare, msg.LossShare, msg.WxShare,
    msg.EncD, msg.EncDBroadcast, msg.MaskedGrad,
    msg.Flag, msg.Control,
]
TYPE_ID = {cls: i + 1 for i, cls in enumerate(MESSAGE_TYPES)}
TYPE_BY_ID = {i: cls for cls, i in TYPE_ID.items()}


class CodecError(ValueError):
    """Malformed, truncated, or inconsistent frame."""


# ---------------------------------------------------------------------------
# header reader/writer
# ---------------------------------------------------------------------------

class _Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def u8(self, v: int):
        self.parts.append(struct.pack("<B", v))

    def u32(self, v: int):
        self.parts.append(struct.pack("<I", v))

    def u64(self, v: int):
        self.parts.append(struct.pack("<Q", v))

    def string(self, s: str):
        b = s.encode()
        if len(b) > 255:
            raise CodecError(f"string field too long ({len(b)} bytes)")
        self.u8(len(b))
        self.parts.append(b)

    def done(self) -> bytes:
        return b"".join(self.parts)


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise CodecError("truncated header")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self._take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def string(self) -> str:
        return self._take(self.u8()).decode()


# ---------------------------------------------------------------------------
# payload codecs
# ---------------------------------------------------------------------------

def _numel(shape) -> int:
    return int(np.prod(shape)) if shape else 1


def _r64_to_bytes(v: R64) -> bytes:
    return np.ascontiguousarray(ring.to_numpy_u64(v).astype("<u8")).tobytes()


def _r64_from_bytes(raw: bytes, shape: tuple[int, ...], device) -> R64:
    if len(raw) != 8 * _numel(shape):
        raise CodecError("ring payload length mismatch")
    flat = np.frombuffer(raw, dtype="<u8").astype(np.uint64)
    return ring.from_numpy_u64(flat.reshape(shape), device)


def _limbs_to_bytes(limbs: np.ndarray, width: int) -> bytes:
    """(n, L) canonical radix-2^12 limbs -> n little-endian residues of
    `width` bytes each (what `int.to_bytes(width, "little")` gives).  Two
    limbs make three bytes."""
    n, L = limbs.shape
    a = limbs.astype(np.uint32)
    if L % 2:
        a = np.pad(a, ((0, 0), (0, 1)))
    lo, hi = a[:, 0::2], a[:, 1::2]
    b = np.empty(lo.shape + (3,), np.uint8)
    b[..., 0] = lo & 0xFF
    b[..., 1] = (lo >> 8) | ((hi & 0xF) << 4)
    b[..., 2] = hi >> 4
    b = b.reshape(n, -1)
    if b.shape[1] < width:
        b = np.pad(b, ((0, 0), (0, width - b.shape[1])))
    elif b[:, width:].any():
        raise CodecError(f"ciphertext residue does not fit {width} bytes")
    return np.ascontiguousarray(b[:, :width]).tobytes()


def _bytes_to_limbs(raw: bytes, n: int, width: int, L: int) -> np.ndarray:
    """Inverse of `_limbs_to_bytes`: (n, L) uint32 limbs.  Raises when a
    residue needs more than L limbs (it is then ≥ 2^(12L) > n²)."""
    b = np.frombuffer(raw, np.uint8).reshape(n, width)
    nbytes = max(-(-width // 3), -(-L // 2)) * 3
    b = np.pad(b, ((0, 0), (0, nbytes - width))).astype(np.uint32)
    b = b.reshape(n, -1, 3)
    lo = b[..., 0] | ((b[..., 1] & 0xF) << 8)
    hi = (b[..., 1] >> 4) | (b[..., 2] << 4)
    limbs = np.stack([lo, hi], axis=-1).reshape(n, -1)
    if limbs[:, L:].any():
        raise CodecError("ciphertext residue out of range (>= n²)")
    return limbs[:, :L]


def _below(limbs: np.ndarray, bound: np.ndarray) -> np.ndarray:
    """Row-wise `limbs < bound` for (n, L) limb rows and one (L,) bound."""
    diff = limbs != bound
    top = limbs.shape[1] - 1 - np.argmax(diff[:, ::-1], axis=1)
    rows = np.arange(limbs.shape[0])
    return diff.any(axis=1) & (limbs[rows, top] < bound[top])


def _mock_ct_payload(v: R64, width: int) -> bytes:
    u = ring.to_numpy_u64(v).reshape(-1)
    out = np.zeros((u.shape[0], width), np.uint8)
    out[:, :8] = np.frombuffer(
        u.astype("<u8").tobytes(), np.uint8).reshape(-1, 8)
    return out.tobytes()


def _mock_ct_from_payload(raw: bytes, width: int, n_cts: int,
                          device) -> R64:
    if len(raw) != width * n_cts:
        raise CodecError("mock ciphertext payload length mismatch")
    arr = np.frombuffer(raw, np.uint8).reshape(n_cts, width)
    if arr[:, 8:].any():
        raise CodecError("mock ciphertext has non-zero padding")
    u = np.frombuffer(arr[:, :8].tobytes(), "<u8").astype(np.uint64)
    return ring.from_numpy_u64(u, device)


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

class Codec:
    """Frame encoder/decoder.

    Args:
      key_provider: optional callable `name -> mod_n2 | None` resolving a
        key owner's Z_{n²} modulus (None = mock backend) — e.g.
        `netparty.PartyServer._resolve_mod`, which late-binds the party's
        HE backend.  Only real-Paillier ciphertext frames need it.
      device: where decoded ring values and ciphertexts are placed.

    `engine` is the `crypto.engine.CryptoEngine` of the Montgomery-domain
    boundary: `engine.make()` (the kernels for CUDA tensors, their plain
    versions for CPU tensors) until the owner sets its backend's.
    """

    def __init__(self, key_provider=None, *, device="cpu"):
        self._key_provider = key_provider
        self.device = torch.device(device)
        self.engine = engine_mod.make()

    def _mod_for(self, owner: str):
        if self._key_provider is None:
            raise CodecError(
                f"no key provider: cannot code ciphertexts under {owner!r}")
        mod = self._key_provider(owner)
        if mod is None:
            raise CodecError(f"no modulus known for key owner {owner!r}")
        return mod

    def _ct_payload(self, cts: torch.Tensor, mod, width: int) -> bytes:
        """Montgomery-domain (n_cts, L2) limbs -> canonical LE residues."""
        canon = self.engine.from_mont(cts, mod)
        return _limbs_to_bytes(canon.cpu().numpy(), width)

    def _ct_from_payload(self, raw: bytes, mod, width: int,
                         n_cts: int) -> torch.Tensor:
        if len(raw) != width * n_cts:
            raise CodecError("ciphertext payload length mismatch")
        limbs = _bytes_to_limbs(raw, n_cts, width, mod.L)
        if n_cts and not _below(limbs, bigint.int_to_limbs(mod.value,
                                                           mod.L)).all():
            raise CodecError("ciphertext residue out of range (>= n²)")
        return self.engine.to_mont(bigint.as_limbs(limbs, self.device), mod)

    # -- encode -------------------------------------------------------------
    def encode(self, m: msg.Message) -> bytes:
        cls = type(m)
        if cls not in TYPE_ID:
            raise CodecError(f"unregistered message type {cls.__name__}")
        w = _Writer()
        w.u8(TYPE_ID[cls])
        w.string(m.src)
        w.string(m.dst)
        kind, payload = self._encode_payload(m, w)
        header = w.done()
        crc = zlib.crc32(header + payload) & 0xFFFFFFFF
        prelude = PRELUDE.pack(MAGIC, VERSION, len(header), len(payload),
                               crc)
        if kind not in (PK_NONE, PK_JSON):
            expect = int(m.wire_bytes())
            if len(payload) != expect:
                raise CodecError(
                    f"{m.tag}: encoded payload is {len(payload)} B but "
                    f"wire_bytes() accounts {expect} B — analytic comm "
                    "accounting drifted from the wire format")
        return prelude + header + payload

    def _encode_payload(self, m: msg.Message, w: _Writer
                        ) -> tuple[int, bytes]:
        """Write the type-specific header fields (in exactly the order
        `_decode_body` reads them back) and return (kind, payload)."""
        if isinstance(m, msg.Flag):
            w.u8(PK_FLAG)
            return PK_FLAG, bytes([1 if m.stop else 0])
        if isinstance(m, msg.Control):
            w.string(m.kind)
            w.u8(PK_JSON)
            return PK_JSON, json.dumps(m.payload or {}).encode()
        if isinstance(m, msg.CipherMessage):
            w.u32(m.n_cts)
            w.u32(m.key_bits)
            w.string(m.key_owner)
            width = ciphertext_wire_bytes(m.key_bits)
            if m.payload is None:
                w.u8(PK_NONE)
                return PK_NONE, b""
            if isinstance(m.payload, R64):
                n = _numel(tuple(m.payload.lo.shape))
                if n != m.n_cts:
                    raise CodecError(
                        f"{m.tag}: n_cts={m.n_cts} but payload has {n}")
                w.u8(PK_CT_MOCK)
                return PK_CT_MOCK, _mock_ct_payload(m.payload, width)
            cts = bigint.as_limbs(m.payload)
            if cts.dim() != 2 or cts.shape[0] != m.n_cts:
                raise CodecError(
                    f"{m.tag}: ciphertext batch shape {tuple(cts.shape)} "
                    f"does not match n_cts={m.n_cts}")
            w.u8(PK_CT)
            return PK_CT, self._ct_payload(cts, self._mod_for(m.key_owner),
                                           width)
        if isinstance(m, msg.RingMessage):
            w.u8(0 if m.n_elems is None else 1)
            w.u64(0 if m.n_elems is None else int(m.n_elems))
            if m.payload is None:
                if m.n_elems is None:
                    raise CodecError(f"{m.tag}: neither payload nor n_elems")
                w.u8(PK_NONE)
                return PK_NONE, b""
            if isinstance(m.payload, R64):
                shape = tuple(int(d) for d in m.payload.lo.shape)
                if m.n_elems is not None \
                        and int(m.n_elems) != _numel(shape):
                    raise CodecError(
                        f"{m.tag}: n_elems={m.n_elems} disagrees with "
                        f"payload shape {shape}")
                w.u8(PK_R64)
                self._write_shape(w, shape)
                return PK_R64, _r64_to_bytes(m.payload)
            arr = m.payload
            if isinstance(arr, torch.Tensor):
                arr = arr.cpu().numpy()
            arr = np.asarray(arr, np.float64)
            shape = tuple(int(d) for d in arr.shape)
            w.u8(PK_F64)
            self._write_shape(w, shape)
            return PK_F64, np.ascontiguousarray(arr.astype("<f8")).tobytes()
        raise CodecError(f"cannot encode {type(m).__name__}")

    @staticmethod
    def _write_shape(w: _Writer, shape: tuple[int, ...]):
        if len(shape) > 255:
            raise CodecError("payload rank > 255")
        w.u8(len(shape))
        for d in shape:
            w.u32(d)

    @staticmethod
    def _read_shape(r: _Reader) -> tuple[int, ...]:
        return tuple(r.u32() for _ in range(r.u8()))

    # -- decode -------------------------------------------------------------
    def decode(self, buf: bytes) -> msg.Message:
        """Decode exactly one frame (it must span the whole buffer)."""
        m, used = self.decode_prefix(buf)
        if used != len(buf):
            raise CodecError(f"{len(buf) - used} trailing bytes after frame")
        return m

    def decode_prefix(self, buf: bytes) -> tuple[msg.Message, int]:
        """Decode one frame from the start of `buf`; returns (msg, size)."""
        if len(buf) < PRELUDE.size:
            raise CodecError("truncated frame (prelude)")
        magic, version, hlen, plen, crc = PRELUDE.unpack_from(buf)
        if magic != MAGIC:
            raise CodecError(f"bad magic {magic!r}")
        if version != VERSION:
            raise CodecError(f"unsupported codec version {version}")
        total = PRELUDE.size + hlen + plen
        if len(buf) < total:
            raise CodecError("truncated frame (body)")
        body = buf[PRELUDE.size:total]
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise CodecError("CRC mismatch (corrupt frame)")
        header, payload = body[:hlen], body[hlen:]
        return self._decode_body(header, payload), total

    def _decode_body(self, header: bytes, payload: bytes) -> msg.Message:
        r = _Reader(header)
        type_id = r.u8()
        cls = TYPE_BY_ID.get(type_id)
        if cls is None:
            raise CodecError(f"unknown message type id {type_id}")
        src, dst = r.string(), r.string()
        if cls is msg.Flag:
            kind = r.u8()
            if kind != PK_FLAG or len(payload) != 1 \
                    or payload[0] not in (0, 1):
                raise CodecError("malformed flag frame")
            return msg.Flag(src, dst, stop=bool(payload[0]))
        if cls is msg.Control:
            ckind = r.string()
            if r.u8() != PK_JSON:
                raise CodecError("malformed control frame")
            try:
                data = json.loads(payload.decode())
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise CodecError(f"bad control JSON: {e}") from None
            return msg.Control(src, dst, payload=data, kind=ckind)
        if issubclass(cls, msg.CipherMessage):
            n_cts, key_bits = r.u32(), r.u32()
            owner = r.string()
            kind = r.u8()
            width = ciphertext_wire_bytes(key_bits)
            if kind == PK_NONE:
                body = None
            elif kind == PK_CT_MOCK:
                body = _mock_ct_from_payload(payload, width, n_cts,
                                             self.device)
            elif kind == PK_CT:
                body = self._ct_from_payload(payload, self._mod_for(owner),
                                             width, n_cts)
            else:
                raise CodecError(f"bad ciphertext payload kind {kind}")
            return cls(src, dst, body, n_cts=n_cts, key_bits=key_bits,
                       key_owner=owner)
        if issubclass(cls, msg.RingMessage):
            has_n = r.u8()
            n_raw = r.u64()
            n_elems = n_raw if has_n else None
            kind = r.u8()
            if kind == PK_NONE:
                return cls(src, dst, None, n_elems=n_elems)
            shape = self._read_shape(r)
            if kind == PK_R64:
                return cls(src, dst,
                           _r64_from_bytes(payload, shape, self.device),
                           n_elems=n_elems)
            if kind == PK_F64:
                if len(payload) != 8 * _numel(shape):
                    raise CodecError("float payload length mismatch")
                arr = np.frombuffer(payload, "<f8").astype(
                    np.float64).reshape(shape)
                return cls(src, dst, arr, n_elems=n_elems)
            raise CodecError(f"bad ring payload kind {kind}")
        raise CodecError(f"cannot decode {cls.__name__}")


def frame_overhead_bytes(frame: bytes) -> int:
    """Header + prelude bytes of an encoded frame (total − payload)."""
    _, _, hlen, _, _ = PRELUDE.unpack_from(frame)
    return PRELUDE.size + hlen
