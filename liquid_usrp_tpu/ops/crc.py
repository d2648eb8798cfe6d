"""CRC-16 / CRC-32 as GF(2)-linear kernels.

Capability parity: the reference selects ``LIQUID_CRC_16`` / ``LIQUID_CRC_32``
data-validity checks per packet (defaults at /root/reference/lib/ofdmtxrx.cc:80
and /root/reference/src/gmskframe_tx.cc:64); every frame decode reports
``payload_valid`` from the CRC.

Batched design: a CRC with ``init=0, xorout=0`` is **linear over GF(2)** in
the message bits.  We therefore precompute (host-side, NumPy):

* ``basis[d]`` — the CRC response to a single 1-bit at distance ``d`` from the
  message end (independent of total length), and
* ``c0[n]``    — the CRC of ``n`` zero bytes with the real init/xorout
  (captures the affine part).

At runtime ``crc(m) = (bits(m) @ basis_slice) % 2  ^  c0[len(m)]`` — one
masked matmul + a table lookup, fully batched/jittable, instead of the
byte-serial table loop of CPU implementations.  Supported message length is
``MAX_LEN`` bytes (checksum of longer buffers can be chained, not needed by
any reference app: max payload there is ~1200 B, /root/reference/src/
ofdmflexframe_tx.cc:62).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..utils.bits import gf2_matmul, unpack_bits

__all__ = [
    "CrcScheme",
    "CRC_NONE",
    "CRC_16",
    "CRC_32",
    "crc_width_bytes",
    "crc_compute",
    "crc_compute_masked",
    "crc_append",
    "crc_check",
]

MAX_LEN = 8192  # bytes; covers every reference payload (<= ~1200 B + header)

# Scheme identifiers (mirrors the reference's LIQUID_CRC_* enum surface).
CRC_NONE = 0
CRC_16 = 1
CRC_32 = 2


class _CrcParams(NamedTuple):
    width: int
    poly: int
    init: int
    refin: bool
    refout: bool
    xorout: int


# CRC-16/ARC ("IBM"): the classic 0x8005 reflected CRC.
_CRC16 = _CrcParams(16, 0x8005, 0x0000, True, True, 0x0000)
# CRC-32 (IEEE 802.3 / zlib).
_CRC32 = _CrcParams(32, 0x04C11DB7, 0xFFFFFFFF, True, True, 0xFFFFFFFF)


def _bitrev(x: int, width: int) -> int:
    r = 0
    for _ in range(width):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def _advance_bit(reg: int, bit: int, p: _CrcParams) -> int:
    mask = (1 << p.width) - 1
    top = (reg >> (p.width - 1)) & 1
    reg = (reg << 1) & mask
    if top ^ bit:
        reg ^= p.poly
    return reg


def _advance_byte(reg: int, byte: int, p: _CrcParams) -> int:
    order = range(8) if p.refin else range(7, -1, -1)
    for k in order:
        reg = _advance_bit(reg, (byte >> k) & 1, p)
    return reg


def _np_crc(data: bytes, p: _CrcParams) -> int:
    """Plain bit-serial reference implementation (host oracle)."""
    reg = p.init
    for b in data:
        reg = _advance_byte(reg, b, p)
    if p.refout:
        reg = _bitrev(reg, p.width)
    return reg ^ p.xorout


def _int_to_bits(x: int, width: int) -> np.ndarray:
    """MSB-first bit vector of an integer."""
    return np.array([(x >> (width - 1 - i)) & 1 for i in range(width)],
                    dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _build_tables(scheme: int):
    """Precompute (basis_desc [MAX_LEN*8, W], c0 [MAX_LEN+1, W]) bit tables.

    ``basis_desc[i]`` is the linear CRC response of a 1-bit at distance
    ``MAX_LEN*8 - 1 - i`` from the message end, so for an ``n``-byte message
    the slice ``basis_desc[-n*8:]`` aligns with its MSB-first unpacked bits.
    """
    if scheme == CRC_16:
        p = _CRC16
    elif scheme == CRC_32:
        p = _CRC32
    else:
        # an unknown (or CRC_NONE) scheme must not silently compute a
        # plausible-looking CRC-32
        raise ValueError(f"unknown CRC scheme id {scheme}")
    w = p.width
    nbits = MAX_LEN * 8

    # Register response of a single byte with bit k set (value 1 << k).
    reg_k = [_advance_byte(0, 1 << k, p) for k in range(8)]

    basis = np.zeros((nbits, w), dtype=np.uint8)  # indexed by distance d
    for db in range(MAX_LEN):
        for k in range(8):
            d = db * 8 + k
            out = reg_k[k]
            if p.refout:
                out = _bitrev(out, w)
            basis[d] = _int_to_bits(out, w)
        # advance all eight registers by one zero byte
        for k in range(8):
            r = reg_k[k]
            for _ in range(8):
                r = _advance_bit(r, 0, p)
            reg_k[k] = r
    basis_desc = basis[::-1].copy()

    # Affine part: CRC of n zero bytes (real init + xorout).
    c0 = np.zeros((MAX_LEN + 1, w), dtype=np.uint8)
    reg = p.init
    for n in range(MAX_LEN + 1):
        out = _bitrev(reg, w) if p.refout else reg
        c0[n] = _int_to_bits(out ^ p.xorout, w)
        for _ in range(8):
            reg = _advance_bit(reg, 0, p)

    # cache NumPy (never jnp: building inside a jit trace would cache a
    # tracer); call sites convert per-use
    return basis_desc, c0


CrcScheme = int  # alias for readability in signatures


def crc_width_bytes(scheme: CrcScheme) -> int:
    return {CRC_NONE: 0, CRC_16: 2, CRC_32: 4}[scheme]


def _bits_to_uint(bits: jnp.ndarray, width: int) -> jnp.ndarray:
    weights = (jnp.uint32(1) << jnp.arange(width - 1, -1, -1, dtype=jnp.uint32))
    return jnp.sum(bits.astype(jnp.uint32) * weights, axis=-1, dtype=jnp.uint32)


def crc_compute(scheme: CrcScheme, data: jnp.ndarray) -> jnp.ndarray:
    """CRC of uint8 ``[..., n]`` (static n) -> uint32 ``[...]``."""
    if scheme == CRC_NONE:
        return jnp.zeros(data.shape[:-1], dtype=jnp.uint32)
    basis_desc, c0 = _build_tables(scheme)
    n = data.shape[-1]
    if n > MAX_LEN:
        raise ValueError(f"message too long for CRC tables: {n} > {MAX_LEN}")
    bits = unpack_bits(data)
    lin = gf2_matmul(bits, jnp.asarray(basis_desc[basis_desc.shape[0] - n * 8:]))
    return _bits_to_uint(lin ^ jnp.asarray(c0[n]), basis_desc.shape[-1])


def crc_compute_masked(scheme: CrcScheme, data: jnp.ndarray,
                       length: jnp.ndarray) -> jnp.ndarray:
    """CRC over the first ``length`` bytes of a max-size buffer (traced len).

    Right-aligns the message inside the buffer (leading zeros contribute
    nothing to the linear part) and looks the affine part up by ``length``.
    ``data``: uint8 ``[n_max]``; ``length``: int scalar <= n_max.
    """
    if scheme == CRC_NONE:
        return jnp.zeros((), dtype=jnp.uint32)
    basis_desc, c0 = _build_tables(scheme)
    n_max = data.shape[-1]
    idx = jnp.arange(n_max)
    masked = jnp.where(idx < length, data, 0).astype(jnp.uint8)
    aligned = jnp.roll(masked, n_max - length, axis=-1)
    bits = unpack_bits(aligned)
    lin = gf2_matmul(bits,
                     jnp.asarray(basis_desc[basis_desc.shape[0] - n_max * 8:]))
    return _bits_to_uint(lin ^ jnp.asarray(c0)[length], basis_desc.shape[-1])


def crc_append(scheme: CrcScheme, data: jnp.ndarray) -> jnp.ndarray:
    """Append the big-endian CRC bytes: uint8 ``[n]`` -> ``[n + w]``."""
    w = crc_width_bytes(scheme)
    if w == 0:
        return data
    c = crc_compute(scheme, data)
    shifts = jnp.arange(w - 1, -1, -1, dtype=jnp.uint32) * 8
    crc_bytes = ((c[..., None] >> shifts) & 0xFF).astype(jnp.uint8)
    return jnp.concatenate([data, crc_bytes], axis=-1)


def crc_check(scheme: CrcScheme, data_with_crc: jnp.ndarray) -> jnp.ndarray:
    """Validate a buffer produced by :func:`crc_append` -> bool ``[...]``."""
    w = crc_width_bytes(scheme)
    if w == 0:
        return jnp.ones(data_with_crc.shape[:-1], dtype=bool)
    data = data_with_crc[..., :-w]
    got = crc_compute(scheme, data)
    shifts = jnp.arange(w - 1, -1, -1, dtype=jnp.uint32) * 8
    want = jnp.sum(
        data_with_crc[..., -w:].astype(jnp.uint32) << shifts, axis=-1,
        dtype=jnp.uint32)
    return got == want


# Host-side oracle (exported for tests).
def np_crc(scheme: CrcScheme, data: bytes) -> int:
    p = _CRC16 if scheme == CRC_16 else _CRC32
    return _np_crc(data, p)
