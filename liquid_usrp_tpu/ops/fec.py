"""Forward error correction as GF(2) matmul + syndrome-gather kernels.

Capability parity: the reference selects inner/outer FEC per packet from the
liquid-dsp scheme set (defaults: Hamming(12,8) at /root/reference/lib/
ofdmtxrx.cc:82, Golay(24,12) at /root/reference/src/ofdmflexframe_tx.cc:72,
Hamming(7,4) at /root/reference/src/gmskframe_tx.cc:65; CLI string parser at
e.g. /root/reference/src/ofdmflexframe_tx.cc:90).

Batched design: every linear block code here is

* encode:  ``bits[nb, k] @ G % 2``  — an integer matmul (dense for batches),
* decode:  syndrome ``r @ H^T % 2`` -> gather into a precomputed
  syndrome -> error-pattern table -> XOR-correct -> take systematic bits.

No bit-twiddling loops; everything is batched over code blocks and jittable.
Convolutional codes (Viterbi as a vectorized trellis ``lax.scan``) live in
:mod:`liquid_usrp_tpu.ops.conv`.

Byte/bit layout: messages are encoded MSB-first; bit stream is chopped into
``k``-bit blocks (zero-padded at the end), each block maps to ``n`` coded
bits, and the coded stream is zero-padded up to a whole byte.  The layout is
deterministic, so a max-size buffer decode agrees with an actual-size decode
on every byte that both cover (this is what lets the frame synchronizers run
with static shapes and mask afterwards).
"""
from __future__ import annotations

import functools
import itertools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.bits import gf2_matmul, pack_bits, unpack_bits

__all__ = [
    "FEC_NONE", "FEC_REP3", "FEC_REP5",
    "FEC_HAMMING74", "FEC_HAMMING84", "FEC_HAMMING128",
    "FEC_GOLAY2412",
    "FEC_SECDED2216", "FEC_SECDED3932", "FEC_SECDED7264",
    "FEC_CONV_V27", "FEC_CONV_V29", "FEC_RS8",
    "fec_names", "fec_from_name", "fec_name",
    "encoded_length", "fec_encode", "fec_decode", "golay_decode_soft",
]

# Scheme ids (stable public enum; mirrors the reference's LIQUID_FEC_* set).
FEC_NONE = 0
FEC_REP3 = 1
FEC_REP5 = 2
FEC_HAMMING74 = 3
FEC_HAMMING84 = 4
FEC_HAMMING128 = 5
FEC_GOLAY2412 = 6
FEC_SECDED2216 = 7
FEC_SECDED3932 = 8
FEC_SECDED7264 = 9
FEC_CONV_V27 = 10
FEC_CONV_V29 = 11
FEC_RS8 = 12
FEC_CONV_V39 = 13
FEC_CONV_V615 = 14
FEC_CONV_V27P23 = 15
FEC_CONV_V27P34 = 16
FEC_CONV_V27P45 = 17
FEC_CONV_V27P56 = 18
FEC_CONV_V27P67 = 19
FEC_CONV_V27P78 = 20
FEC_CONV_V29P23 = 21
FEC_CONV_V29P34 = 22
FEC_CONV_V29P45 = 23
FEC_CONV_V29P56 = 24
FEC_CONV_V29P67 = 25
FEC_CONV_V29P78 = 26

_NAMES = {
    FEC_NONE: "none", FEC_REP3: "rep3", FEC_REP5: "rep5",
    FEC_HAMMING74: "h74", FEC_HAMMING84: "h84", FEC_HAMMING128: "h128",
    FEC_GOLAY2412: "g2412",
    FEC_SECDED2216: "secded2216", FEC_SECDED3932: "secded3932",
    FEC_SECDED7264: "secded7264",
    FEC_CONV_V27: "v27", FEC_CONV_V29: "v29",
    FEC_RS8: "rs8",
    FEC_CONV_V39: "v39", FEC_CONV_V615: "v615",
    FEC_CONV_V27P23: "v27p23", FEC_CONV_V27P34: "v27p34",
    FEC_CONV_V27P45: "v27p45", FEC_CONV_V27P56: "v27p56",
    FEC_CONV_V27P67: "v27p67", FEC_CONV_V27P78: "v27p78",
    FEC_CONV_V29P23: "v29p23", FEC_CONV_V29P34: "v29p34",
    FEC_CONV_V29P45: "v29p45", FEC_CONV_V29P56: "v29p56",
    FEC_CONV_V29P67: "v29p67", FEC_CONV_V29P78: "v29p78",
}
_BY_NAME = {v: k for k, v in _NAMES.items()}
# Aliases accepted by the reference CLI parser surface.
_BY_NAME.update({"hamming74": FEC_HAMMING74, "hamming84": FEC_HAMMING84,
                 "hamming128": FEC_HAMMING128, "golay2412": FEC_GOLAY2412})


def fec_names():
    return list(_NAMES.values())


def fec_from_name(name: str) -> int:
    try:
        return _BY_NAME[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown FEC scheme '{name}'; supported: {fec_names()}")


def fec_name(scheme: int) -> str:
    return _NAMES[scheme]


class _BlockCode(NamedTuple):
    k: int                  # data bits per block
    n: int                  # coded bits per block
    G: np.ndarray           # [k, n] systematic generator, G = [I_k | P]
    H: np.ndarray           # [n-k, n] parity check, H = [P^T | I_{n-k}]
    syn_table: np.ndarray   # [2^(n-k), n] syndrome -> error pattern


def _H_from_G(G: np.ndarray) -> np.ndarray:
    k, n = G.shape
    return np.concatenate([G[:, k:].T, np.eye(n - k, dtype=np.uint8)], axis=1)


def _syndrome_int(H: np.ndarray, e: np.ndarray) -> int:
    s_bits = (H @ e) % 2
    s = 0
    for b in s_bits:
        s = (s << 1) | int(b)
    return s


def _single_error_table(H: np.ndarray) -> np.ndarray:
    """Syndrome table correcting single-bit errors (first column match wins)."""
    r, n = H.shape
    syn_table = np.zeros((1 << r, n), dtype=np.uint8)
    for pos in range(n):
        e = np.zeros(n, dtype=np.uint8)
        e[pos] = 1
        s = _syndrome_int(H, e)
        if s and not syn_table[s].any():
            syn_table[s, pos] = 1
    return syn_table


def _systematic_from_H_cols(a_cols: list[int], r: int) -> _BlockCode:
    """Build a systematic SEC code from the non-unit columns of H.

    ``H = [A | I_r]`` with ``A``'s columns given as ``r``-bit integers; data
    bits come first, parity bits last.  Syndrome table corrects single-bit
    errors (unique column match); unmatched syndromes correct nothing.
    """
    k = len(a_cols)
    A = np.zeros((r, k), dtype=np.uint8)
    for j, c in enumerate(a_cols):
        for i in range(r):
            A[i, j] = (c >> (r - 1 - i)) & 1
    G = np.concatenate([np.eye(k, dtype=np.uint8), A.T], axis=1)
    H = _H_from_G(G)
    return _BlockCode(k, k + r, G, H, _single_error_table(H))


def _extend_parity(code: _BlockCode) -> _BlockCode:
    """Add an overall parity bit (SEC -> SEC-DED extension).

    The table is built from the same systematic ``H = [P^T | I]`` the decoder
    computes, so syndromes match by construction.
    """
    k, n = code.k, code.n
    G = np.concatenate(
        [code.G, (code.G.sum(axis=1) % 2)[:, None].astype(np.uint8)], axis=1)
    H = _H_from_G(G)
    return _BlockCode(k, n + 1, G, H, _single_error_table(H))


def _golay_code() -> _BlockCode:
    """Extended binary Golay (24,12,8): G = [I | B], corrects 3 errors.

    ``B`` is the standard bordered circulant built from the quadratic
    residues of 11.
    """
    qr = {1, 3, 4, 5, 9}  # quadratic residues mod 11
    B = np.zeros((12, 12), dtype=np.uint8)
    for i in range(11):
        for j in range(11):
            B[i, j] = 1 if ((j - i) % 11) in qr else 0
        B[i, 11] = 1
        B[11, i] = 1
    B[11, 11] = 0
    G = np.concatenate([np.eye(12, dtype=np.uint8), B], axis=1)
    H = _H_from_G(G)

    syn_table = np.zeros((1 << 12, 24), dtype=np.uint8)
    seen = np.zeros(1 << 12, dtype=bool)
    # enumerate error patterns by increasing weight; first writer wins
    for w in range(0, 5):
        for pos in itertools.combinations(range(24), w):
            e = np.zeros(24, dtype=np.uint8)
            e[list(pos)] = 1
            s = _syndrome_int(H, e)
            if not seen[s]:
                seen[s] = True
                syn_table[s] = e
        if seen.all():
            break
    assert seen.all()
    return _BlockCode(12, 24, G, H, syn_table)


@functools.lru_cache(maxsize=None)
def _block_code(scheme: int) -> _BlockCode:
    if scheme == FEC_HAMMING74:
        # H columns (data) = non-unit nonzero 3-bit values
        return _systematic_from_H_cols([0b011, 0b101, 0b110, 0b111], 3)
    if scheme == FEC_HAMMING84:
        return _extend_parity(_block_code(FEC_HAMMING74))
    if scheme == FEC_HAMMING128:
        return _systematic_from_H_cols(
            [0b0011, 0b0101, 0b0110, 0b0111, 0b1001, 0b1010, 0b1011, 0b1100],
            4)
    if scheme == FEC_GOLAY2412:
        return _golay_code()
    if scheme == FEC_SECDED2216:
        cols = [c for c in range(3, 32) if bin(c).count("1") >= 2][:16]
        return _extend_parity(_systematic_from_H_cols(cols, 5))
    if scheme == FEC_SECDED3932:
        cols = [c for c in range(3, 64) if bin(c).count("1") >= 2][:32]
        return _extend_parity(_systematic_from_H_cols(cols, 6))
    if scheme == FEC_SECDED7264:
        cols = [c for c in range(3, 128) if bin(c).count("1") >= 2][:64]
        return _extend_parity(_systematic_from_H_cols(cols, 7))
    raise ValueError(f"not a block code scheme: {scheme}")


def _is_rep(scheme):
    return scheme in (FEC_REP3, FEC_REP5)


def _is_conv(scheme):
    return FEC_CONV_V27 <= scheme <= FEC_CONV_V29 or \
        FEC_CONV_V39 <= scheme <= FEC_CONV_V29P78


def encoded_length(scheme: int, n_bytes: int) -> int:
    """Encoded size in bytes for an ``n_bytes`` input message."""
    if scheme == FEC_NONE:
        return n_bytes
    if scheme == FEC_RS8:
        from . import rs
        return rs.rs_encoded_length(n_bytes)
    if scheme == FEC_REP3:
        return 3 * n_bytes
    if scheme == FEC_REP5:
        return 5 * n_bytes
    if _is_conv(scheme):
        from . import conv
        return conv.encoded_length(scheme, n_bytes)
    c = _block_code(scheme)
    nbits = n_bytes * 8
    nblocks = -(-nbits // c.k)
    return -(-(nblocks * c.n) // 8)


def fec_encode(scheme: int, data: jnp.ndarray) -> jnp.ndarray:
    """Encode uint8 ``[..., n]`` -> uint8 ``[..., encoded_length(n)]``."""
    if scheme == FEC_NONE:
        return data
    if scheme == FEC_RS8:
        from . import rs
        return rs.rs_encode(data)
    if _is_rep(scheme):
        # byte-local repetition (each byte r times consecutively) so that a
        # max-size buffer decode agrees with an actual-size decode on every
        # shared byte (required by the static-shape frame synchronizers)
        r = 3 if scheme == FEC_REP3 else 5
        return jnp.repeat(data, r, axis=-1)
    if _is_conv(scheme):
        from . import conv
        return conv.conv_encode(scheme, data)
    c = _block_code(scheme)
    nbits = data.shape[-1] * 8
    nblocks = -(-nbits // c.k)
    bits = unpack_bits(data)
    pad = nblocks * c.k - nbits
    if pad:
        bits = jnp.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    blocks = bits.reshape(*bits.shape[:-1], nblocks, c.k)
    coded = gf2_matmul(blocks, jnp.asarray(c.G))
    flat = coded.reshape(*coded.shape[:-2], nblocks * c.n)
    out_bytes = encoded_length(scheme, data.shape[-1])
    pad2 = out_bytes * 8 - flat.shape[-1]
    if pad2:
        flat = jnp.pad(flat, [(0, 0)] * (flat.ndim - 1) + [(0, pad2)])
    return pack_bits(flat)


@functools.lru_cache(maxsize=None)
def _golay_codewords_pm1() -> np.ndarray:
    """All 4096 Golay(24,12) codewords as ±1 rows ``[4096, 24]``."""
    c = _block_code(FEC_GOLAY2412)
    msgs = np.arange(1 << 12, dtype=np.uint32)
    mbits = ((msgs[:, None] >> np.arange(11, -1, -1)) & 1).astype(np.uint8)
    cw = (mbits @ c.G) % 2
    return (2.0 * cw - 1.0).astype(np.float32)


def golay_decode_soft(llr_blocks: jnp.ndarray) -> jnp.ndarray:
    """Exact maximum-likelihood soft decode of Golay(24,12).

    ``llr_blocks [..., 24]`` float LLRs (positive => bit 1) -> message
    bits ``[..., 12]`` uint8.  ML = argmax over codeword correlations,
    computed as ONE dense ``[..., 24] @ [24, 4096]`` matmul — the
    accelerator-shaped formulation of what a CPU decoder does with
    syndrome tables; worth ~2 dB over hard-decision syndrome decoding
    at the header's operating point.
    """
    cw = jnp.asarray(_golay_codewords_pm1())           # [4096, 24]
    # HIGHEST: in TF32 the LLRs keep ~3 decimal digits, enough to flip
    # the argmax between two near-tied codewords
    score = jnp.matmul(llr_blocks.astype(jnp.float32), cw.T,
                       precision=jax.lax.Precision.HIGHEST)  # [..., 4096]
    best = jnp.argmax(score, axis=-1).astype(jnp.uint32)
    bits = (best[..., None] >> jnp.arange(11, -1, -1, dtype=jnp.uint32)) & 1
    return bits.astype(jnp.uint8)


def fec_decode(scheme: int, coded: jnp.ndarray, n_bytes: int) -> jnp.ndarray:
    """Decode uint8 ``[..., encoded_length(n_bytes)]`` -> uint8 ``[..., n_bytes]``.

    Hard-decision decode; block codes correct up to their design distance via
    the syndrome table (Golay: 3 bits/24; Hamming: 1 bit/block; repetition:
    bitwise majority).
    """
    if scheme == FEC_NONE:
        return coded[..., :n_bytes]
    if scheme == FEC_RS8:
        from . import rs
        if coded.ndim > 1:     # the RS core is 1-D; honor the [..., n]
            flat = coded.reshape(-1, coded.shape[-1])        # contract
            out = jax.vmap(lambda c: rs.rs_decode(c, n_bytes))(flat)
            return out.reshape(*coded.shape[:-1], n_bytes)
        return rs.rs_decode(coded, n_bytes)
    if _is_rep(scheme):
        r = 3 if scheme == FEC_REP3 else 5
        copies = coded[..., : n_bytes * r].reshape(
            *coded.shape[:-1], n_bytes, r)
        bits = unpack_bits(copies).reshape(*coded.shape[:-1], n_bytes, r, 8)
        maj = (jnp.sum(bits.astype(jnp.int32), axis=-2) * 2 > r)
        return pack_bits(maj.astype(jnp.uint8).reshape(
            *coded.shape[:-1], n_bytes * 8))
    if _is_conv(scheme):
        from . import conv
        if coded.ndim > 1:     # the Viterbi core is 1-D (see RS above)
            flat = coded.reshape(-1, coded.shape[-1])
            out = jax.vmap(
                lambda c: conv.conv_decode(scheme, c, n_bytes))(flat)
            return out.reshape(*coded.shape[:-1], n_bytes)
        return conv.conv_decode(scheme, coded, n_bytes)
    c = _block_code(scheme)
    nbits = n_bytes * 8
    nblocks = -(-nbits // c.k)
    bits = unpack_bits(coded)[..., :nblocks * c.n]
    blocks = bits.reshape(*bits.shape[:-1], nblocks, c.n)
    syn_bits = gf2_matmul(blocks, jnp.asarray(c.H.T))  # [..., nblocks, n-k]
    weights = (jnp.uint32(1) << jnp.arange(c.n - c.k - 1, -1, -1,
                                           dtype=jnp.uint32))
    syn = jnp.sum(syn_bits.astype(jnp.uint32) * weights, axis=-1,
                  dtype=jnp.uint32)
    err = jnp.asarray(c.syn_table)[syn]          # gather [..., nblocks, n]
    corrected = blocks ^ err
    data_bits = corrected[..., :c.k].reshape(*blocks.shape[:-2],
                                             nblocks * c.k)[..., :nbits]
    return pack_bits(data_bits)
