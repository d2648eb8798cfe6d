"""Reed-Solomon RS(255,223) over GF(256) — batched device codec.

Capability parity: liquid-dsp offers ``rs8``, an RS(255,223) code (via the
optional libfec the reference probes for at /root/reference/
configure.ac:76-82); the CLI string parser exposes it to every app.  This
implementation uses the conventional GF(256) generated by ``x^8+x^4+x^3+
x^2+1`` (0x11D), first consecutive root alpha^1 (t = 16 byte errors per
block).

Batched formulation:

* **Encode and syndromes are GF(2)-linear**: multiplying a GF(256) element
  by a *constant* is linear over its 8 component bits, so the systematic
  parity map (message -> 32 parity bytes) and the syndrome map (codeword ->
  32 syndromes) are precomputed binary matrices; both run as single
  ``gf2_matmul`` dots (the same trick as the CRC kernel).
* **Berlekamp-Massey** runs a fixed 32-iteration ``fori_loop`` with masked
  updates, vectorized over blocks.
* **Chien search + Forney** evaluate the locator/evaluator polynomials at
  every codeword position at once through precomputed inverse-power tables
  and log/antilog gathers.

Shortening: messages are chopped into <=223-byte blocks; a short block is
zero-padded (the zero bytes are stripped on the wire and re-inserted,
position-consistently, before decoding).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.bits import gf2_matmul, pack_bits, unpack_bits

__all__ = ["RS_N", "RS_K", "rs_encoded_length", "rs_encode", "rs_decode"]

RS_N = 255
RS_K = 223
_T = 16                          # correctable byte errors per block
_NPAR = 2 * _T                   # 32 parity bytes
_PRIM = 0x11D
_FCR = 1                         # first consecutive root exponent


# ---------------------------------------------------------------------------
# host-side GF(256) arithmetic + table construction
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _gf_tables():
    antilog = np.zeros(510, dtype=np.int32)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        antilog[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _PRIM
    antilog[255:] = antilog[:255]
    return log, antilog


def _mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    log, antilog = _gf_tables()
    return int(antilog[log[a] + log[b]])


def _pow(a: int, n: int) -> int:
    if a == 0:
        return 0
    log, antilog = _gf_tables()
    return int(antilog[(log[a] * (n % 255)) % 255])


def _inv(a: int) -> int:
    log, antilog = _gf_tables()
    return int(antilog[(255 - log[a]) % 255])


@functools.lru_cache(maxsize=None)
def _gen_poly() -> np.ndarray:
    """g(x) = prod_{j=0}^{2t-1} (x - alpha^(FCR+j)), low-degree first."""
    g = np.array([1], dtype=np.int64)
    for j in range(_NPAR):
        r = _pow(2, _FCR + j)
        ng = np.zeros(len(g) + 1, dtype=np.int64)
        for i, c in enumerate(g):
            ng[i] ^= _mul(int(c), r)     # * (-r) == * r in GF(2^m)
            ng[i + 1] ^= int(c)          # * x
        g = ng
    assert g[-1] == 1
    return g


def _np_parity(msg: np.ndarray) -> np.ndarray:
    """Systematic parity of a K-byte message (polynomial long division).

    Codeword = [msg | parity]; msg[0] is the x^(N-1) coefficient, parity
    occupies degrees NPAR-1..0 (parity[0] = degree NPAR-1 coefficient).
    """
    g = _gen_poly()
    rem = np.zeros(_NPAR, dtype=np.int64)  # rem[k] = coeff of x^(NPAR-1-k)
    for m in msg:
        fb = int(m) ^ int(rem[0])
        rem[:-1] = rem[1:]
        rem[-1] = 0
        if fb:
            for k in range(_NPAR):
                # subtract fb * g(x) * x^(appropriate); g coeff for
                # degree NPAR-1-k is g[NPAR-1-k]
                rem[k] ^= _mul(fb, int(g[_NPAR - 1 - k]))
    return rem.astype(np.uint8)


def _np_syndromes(code: np.ndarray) -> np.ndarray:
    """S_j = c(alpha^(FCR+j)), c(x) = sum_i code[i] x^(N-1-i)."""
    out = np.zeros(_NPAR, dtype=np.int64)
    for j in range(_NPAR):
        a = _pow(2, _FCR + j)
        acc = 0
        for c in code:
            acc = _mul(acc, a) ^ int(c)  # Horner
        out[j] = acc
    return out.astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _codec_matrices():
    """Binary parity matrix P [K*8, NPAR*8] and syndrome matrix
    S [N*8, NPAR*8] (probed bit-by-bit from the reference maps)."""
    P = np.zeros((RS_K * 8, _NPAR * 8), dtype=np.uint8)
    msg = np.zeros(RS_K, dtype=np.uint8)
    for byte in range(RS_K):
        for bit in range(8):
            msg[:] = 0
            msg[byte] = 1 << (7 - bit)
            P[byte * 8 + bit] = np.unpackbits(_np_parity(msg))
    S = np.zeros((RS_N * 8, _NPAR * 8), dtype=np.uint8)
    code = np.zeros(RS_N, dtype=np.uint8)
    for byte in range(RS_N):
        for bit in range(8):
            code[:] = 0
            code[byte] = 1 << (7 - bit)
            S[byte * 8 + bit] = np.unpackbits(_np_syndromes(code))
    return P, S


@functools.lru_cache(maxsize=None)
def _position_tables():
    """Per-position inverse-power tables for Chien/Forney.

    Position ``i`` on the wire is the degree-(N-1-i) coefficient, so its
    locator root is ``X_i = alpha^(N-1-i)``.  Tables (length N):
      * ``lam_pows[i, k]  = X_i^-k``            (k = 0..T,  Lambda eval)
      * ``om_pows[i, j]   = X_i^-j``            (j = 0..2t-1, Omega eval)
      * ``dlam_pows[i, k] = X_i^-(k-1)`` for odd k else 0 (Lambda' eval)
      * ``xfac[i]         = X_i^(1-FCR)``       (Forney factor)
    """
    lam = np.zeros((RS_N, _T + 1), dtype=np.int32)
    om = np.zeros((RS_N, _NPAR), dtype=np.int32)
    dlam = np.zeros((RS_N, _T + 1), dtype=np.int32)
    xfac = np.zeros(RS_N, dtype=np.int32)
    for i in range(RS_N):
        X = _pow(2, RS_N - 1 - i)
        Xi = _inv(X)
        for k in range(_T + 1):
            lam[i, k] = _pow(Xi, k)
            if k % 2 == 1:
                dlam[i, k] = _pow(Xi, k - 1)
        for j in range(_NPAR):
            om[i, j] = _pow(Xi, j)
        xfac[i] = _pow(X, 1 - _FCR)
    return lam, om, dlam, xfac


# ---------------------------------------------------------------------------
# block layout / shortening
# ---------------------------------------------------------------------------

def _block_layout(n_bytes: int):
    """(nblocks, data_lens): data bytes per block (last may be short)."""
    nblocks = max(1, -(-n_bytes // RS_K))
    lens = [RS_K] * nblocks
    lens[-1] = n_bytes - RS_K * (nblocks - 1)
    return nblocks, lens


def rs_encoded_length(n_bytes: int) -> int:
    nblocks, _ = _block_layout(n_bytes)
    return n_bytes + nblocks * _NPAR


def rs_encode(data: jnp.ndarray) -> jnp.ndarray:
    """Encode uint8 ``[n]`` -> ``[n + 32 * nblocks]`` (systematic,
    shortened last block)."""
    P, _ = _codec_matrices()
    n = int(data.shape[-1])
    nblocks, lens = _block_layout(n)
    padded = jnp.concatenate(
        [data.astype(jnp.uint8),
         jnp.zeros(nblocks * RS_K - n, jnp.uint8)]).reshape(nblocks, RS_K)
    bits = unpack_bits(padded)
    parity = pack_bits(gf2_matmul(bits, jnp.asarray(P)))  # [nblocks, NPAR]
    pieces = []
    for b in range(nblocks):
        pieces.append(padded[b, : lens[b]])
        pieces.append(parity[b])
    return jnp.concatenate(pieces)


def _gfv(log_t, antilog_t, a, b):
    """Elementwise GF(256) multiply via table gathers (int32 in/out)."""
    prod = antilog_t[log_t[a] + log_t[b]]
    return jnp.where((a == 0) | (b == 0), 0, prod)


def rs_decode(coded: jnp.ndarray, n_bytes: int) -> jnp.ndarray:
    """Decode -> uint8 ``[n_bytes]`` (corrects <=16 byte errors/block)."""
    _, S = _codec_matrices()
    lam_np, om_np, dlam_np, xfac_np = _position_tables()
    log_np, antilog_np = _gf_tables()
    log_t = jnp.asarray(log_np)
    antilog_t = jnp.asarray(antilog_np)

    nblocks, lens = _block_layout(n_bytes)
    # rebuild full N-byte codewords (insert virtual zeros for short blocks)
    rows = []
    off = 0
    for b in range(nblocks):
        d = lens[b]
        blk_data = coded[off: off + d]
        off += d
        blk_par = coded[off: off + _NPAR]
        off += _NPAR
        row = jnp.concatenate([
            blk_data.astype(jnp.uint8),
            jnp.zeros(RS_K - d, jnp.uint8), blk_par.astype(jnp.uint8)])
        rows.append(row)
    blocks = jnp.stack(rows).astype(jnp.int32)          # [B, N]
    B = nblocks

    # syndromes: one matmul (note: virtual zeros sit at positions
    # lens[b]..K-1, matching _np_syndromes' coefficient layout only if the
    # zeros are where the encoder had them — the encoder padded at the END
    # of the data region, same as here)
    syn_bits = gf2_matmul(unpack_bits(blocks.astype(jnp.uint8)),
                          jnp.asarray(S))
    synd = pack_bits(syn_bits).astype(jnp.int32)        # [B, 2t]

    # --- Berlekamp-Massey (fixed 2t iterations, masked updates) ---
    kidx = jnp.arange(_T + 1)

    def bm_body(n, carry):
        C, Bb, L, b, m = carry
        # d = synd[n] ^ sum_{i=1..T} C[i] * synd[n-i]
        i = jnp.arange(1, _T + 1)
        sidx = n - i
        s_prev = jnp.where(sidx[None, :] >= 0,
                           synd[jnp.arange(B)[:, None],
                                jnp.clip(sidx, 0, _NPAR - 1)[None, :]], 0)
        d = synd[:, n]
        d = d ^ jax.lax.reduce(_gfv(log_t, antilog_t, C[:, 1:], s_prev),
                               jnp.int32(0), jax.lax.bitwise_xor, (1,))
        nz = d != 0
        db = _gfv(log_t, antilog_t, d,
                  antilog_t[(255 - log_t[jnp.maximum(b, 1)]) % 255])
        # shifted[k] = Bb[k - m] (0 for k < m)
        gather = jnp.clip(kidx[None, :] - m[:, None], 0, _T)
        shifted = jnp.where(kidx[None, :] >= m[:, None],
                            Bb[jnp.arange(B)[:, None], gather], 0)
        delta = _gfv(log_t, antilog_t, db[:, None], shifted)
        C_new = jnp.where(nz[:, None], C ^ delta, C)
        grow = nz & (2 * L <= n)
        Bb_new = jnp.where(grow[:, None], C, Bb)
        b_new = jnp.where(grow, d, b)
        L_new = jnp.where(grow, n + 1 - L, L)
        m_new = jnp.where(grow, 1, m + 1)
        return C_new, Bb_new, L_new, b_new, m_new

    C0 = jnp.zeros((B, _T + 1), jnp.int32).at[:, 0].set(1)
    carry = (C0, C0, jnp.zeros(B, jnp.int32), jnp.ones(B, jnp.int32),
             jnp.ones(B, jnp.int32))
    C, _, L, _, _ = jax.lax.fori_loop(0, _NPAR, bm_body, carry)

    # --- Omega = S(x) * Lambda(x) mod x^2t ---
    # one vectorized polynomial product: omega[n] = XOR_i C[i]*S[n-i]
    # (a [B, T+1, NPAR] GF product + masked diagonal XOR-reduce — the
    # scalar double loop used to emit 544 chained buffer updates per
    # trace, dominating rs_decode's compile time)
    prods = _gfv(log_t, antilog_t, C[:, :_T + 1, None],
                 synd[:, None, :])                     # [B, T+1, NPAR]
    n_idx = jnp.arange(_NPAR)[:, None]                 # omega power
    i_idx = jnp.arange(_T + 1)[None, :]                # lambda power
    j_idx = n_idx - i_idx                              # syndrome power
    valid = (j_idx >= 0) & (j_idx < _NPAR)
    gathered = prods[:, i_idx, jnp.clip(j_idx, 0, _NPAR - 1)]  # [B,NPAR,T+1]
    omega = jax.lax.reduce(
        jnp.where(valid[None], gathered, 0),
        jnp.int32(0), jax.lax.bitwise_xor, (2,))       # [B, NPAR]

    # --- Chien + Forney over all positions at once ---
    lam_eval = jax.lax.reduce(
        _gfv(log_t, antilog_t, C[:, None, :],
             jnp.asarray(lam_np)[None, :, :]),
        jnp.int32(0), jax.lax.bitwise_xor, (2,))        # [B, N]
    om_eval = jax.lax.reduce(
        _gfv(log_t, antilog_t, omega[:, None, :],
             jnp.asarray(om_np)[None, :, :]),
        jnp.int32(0), jax.lax.bitwise_xor, (2,))
    dlam_eval = jax.lax.reduce(
        _gfv(log_t, antilog_t, C[:, None, :],
             jnp.asarray(dlam_np)[None, :, :]),
        jnp.int32(0), jax.lax.bitwise_xor, (2,))
    is_err = (lam_eval == 0) & (dlam_eval != 0)
    inv_dlam = antilog_t[(255 - log_t[jnp.maximum(dlam_eval, 1)]) % 255]
    mag = _gfv(log_t, antilog_t, om_eval, inv_dlam)
    mag = _gfv(log_t, antilog_t, mag,
               jnp.broadcast_to(jnp.asarray(xfac_np)[None, :],
                                mag.shape))
    err = jnp.where(is_err, mag, 0)
    corrected = (blocks ^ err).astype(jnp.uint8)

    out = [corrected[b, : lens[b]] for b in range(nblocks)]
    return jnp.concatenate(out)


# host oracle (exported for tests)
def np_rs_roundtrip_check(msg: np.ndarray) -> bool:
    cw = np.concatenate([msg, _np_parity(msg)])
    return not _np_syndromes(cw).any()
