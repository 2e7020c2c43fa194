"""Byte <-> field-element packing rules (parity with the reference's
`common/src/utils.rs:1-219`).

Three distinct layouts coexist in the reference — do not mix them up
(SURVEY.md §7 pitfalls):
  * digest packing:    8 bytes/felt, LE 64-bit limbs (`digest_*`)
  * injective packing: 4 bytes/felt, LE 32-bit limbs (`injective_*`)
  * u64 packing:       2 felts, (hi, lo) order (`u64_to_felts`)
  * u128 packing:      4 felts, big-end-first 32-bit limbs
Field elements are numpy uint64 (canonical).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.goldilocks import P

INJECTIVE_BYTES_PER_ELEMENT = 4
DIGEST_BYTES_PER_ELEMENT = 8
FELTS_PER_U128 = 4
FELTS_PER_U64 = 2
DIGEST_NUM_FIELD_ELEMENTS = 4

BIT_32_LIMB_MASK = 0xFFFF_FFFF

ZERO_DIGEST = np.zeros(4, dtype=np.uint64)


class DigestError(ValueError):
    """A 32-byte digest whose 8-byte LE chunks are not all < p."""

    def __init__(self, chunk_index: int, value: int):
        self.chunk_index = chunk_index
        self.value = value
        super().__init__(
            f"digest chunk {chunk_index} out of field range: {value:#x}"
        )


class FeltWidthError(ValueError):
    """A field element exceeded the expected 32-bit limb width."""

    def __init__(self, index: int, value: int):
        self.index = index
        self.value = value
        super().__init__(f"felt {index} is not a 32-bit limb: {value:#x}")


@dataclass(frozen=True)
class BytesDigest:
    """32 bytes validated so each 8-byte LE chunk is < p
    (reference: `common/src/utils.rs:41-55`)."""

    data: bytes

    def __post_init__(self):
        if len(self.data) != 32:
            raise ValueError(
                f"expected 32 bytes for digest, got {len(self.data)}"
            )
        for i in range(4):
            v = int.from_bytes(self.data[8 * i : 8 * i + 8], "little")
            if v >= P:
                raise DigestError(i, v)

    @classmethod
    def from_felts(cls, felts) -> "BytesDigest":
        return cls(bytes(digest_felts_to_bytes(felts)))

    def __bytes__(self) -> bytes:
        return self.data

    def __iter__(self):
        return iter(self.data)


def _check_32_bit_limb(value: int, index: int) -> int:
    if value > BIT_32_LIMB_MASK:
        raise FeltWidthError(index, value)
    return value


def u128_to_felts(num: int) -> np.ndarray:
    """u128 -> 4 felts of 32-bit limbs, big-end first (utils.rs:104-115)."""
    assert 0 <= num < (1 << 128)
    return np.array(
        [(num >> (96 - 32 * i)) & BIT_32_LIMB_MASK for i in range(4)],
        dtype=np.uint64,
    )


def felts_to_u128(felts) -> int:
    felts = np.asarray(felts, dtype=np.uint64)
    assert felts.shape == (4,)
    out = 0
    for i, f in enumerate(felts):
        limb = _check_32_bit_limb(int(f), i)
        out |= limb << (96 - 32 * i)
    return out


def u64_to_felts(num: int) -> np.ndarray:
    """u64 -> 2 felts (hi, lo) of 32-bit limbs (utils.rs:126-131)."""
    assert 0 <= num < (1 << 64)
    return np.array(
        [(num >> 32) & BIT_32_LIMB_MASK, num & BIT_32_LIMB_MASK],
        dtype=np.uint64,
    )


def injective_string_to_felts(s: str) -> np.ndarray:
    """Exactly-8-byte string -> 2 felts of LE u32 (utils.rs:145-159)."""
    b = s.encode()
    if len(b) != 8:
        raise ValueError("String must be exactly 8 bytes long")
    return np.array(
        [
            int.from_bytes(b[0:4], "little"),
            int.from_bytes(b[4:8], "little"),
        ],
        dtype=np.uint64,
    )


def injective_bytes_to_felts(data: bytes) -> np.ndarray:
    """4 bytes/felt LE, zero-padded final chunk (utils.rs:162-174)."""
    out = []
    for i in range(0, len(data), INJECTIVE_BYTES_PER_ELEMENT):
        chunk = data[i : i + INJECTIVE_BYTES_PER_ELEMENT]
        chunk = chunk + b"\x00" * (INJECTIVE_BYTES_PER_ELEMENT - len(chunk))
        out.append(int.from_bytes(chunk, "little"))
    return np.array(out, dtype=np.uint64)


def injective_felts_to_bytes(felts) -> bytes:
    """Inverse of injective_bytes_to_felts; validates 32-bit width
    (utils.rs:177-187)."""
    felts = np.asarray(felts, dtype=np.uint64).ravel()
    out = bytearray()
    for i, f in enumerate(felts):
        limb = _check_32_bit_limb(int(f), i)
        out += limb.to_bytes(4, "little")
    return bytes(out)


def digest_bytes_to_felts(digest: "BytesDigest | bytes") -> np.ndarray:
    """32 bytes -> 4 felts, 8 bytes/felt LE (utils.rs:189-201)."""
    data = bytes(digest)
    assert len(data) == 32
    return np.array(
        [
            int.from_bytes(data[8 * i : 8 * i + 8], "little")
            for i in range(4)
        ],
        dtype=np.uint64,
    )


def digest_felts_to_bytes(felts) -> bytes:
    """4 felts -> 32 bytes, 8 bytes/felt LE (utils.rs:203-215)."""
    felts = np.asarray(felts, dtype=np.uint64).ravel()
    assert felts.shape == (4,)
    return b"".join(int(f).to_bytes(8, "little") for f in felts)
