"""802.11a OFDM frame generation (wlanframegen parity).

Capability parity: the reference's optional ``wlanframe_tx`` app drives
``liquid-wlan``'s ``wlanframegen`` (/root/reference/src/wlanframe_tx.cc:
174-231 — 80-sample symbols, rates 6-54 Mb/s; excluded from its default
build at makefile.in:114).  This module implements the 802.11a (1999) PHY
transmit chain from the public standard:

* 64-subcarrier OFDM, 48 data + 4 pilot carriers (+-7, +-21), 16-sample CP,
* short + long training preambles (160 + 160 samples),
* SIGNAL field (rate/length, BPSK, rate-1/2 conv, 1 symbol),
* DATA: service+PSDU+tail+pad, frame-synchronous scrambler (x^7+x^4+1),
  K=7 (133,171) convolutional coding with 2/3 and 3/4 puncturing,
  per-symbol block interleaver, BPSK/QPSK/16-QAM/64-QAM mapping, pilot
  polarity PN.

Everything is batched: one pass builds all symbols, one IFFT, CP via
slicing.

The RX side (beyond the reference: liquid-wlan ships no receiver) is a
jitted streaming synchronizer in the house style — ``wlan_sync_block(sync,
state, block) -> (state', WlanResults)`` with static shapes: segmented
long-training cross-correlation detection, vmapped gated candidate decode
(two-stage ST/LT CFO, LT channel EQ, pilot common-phase tracking, rate
``lax.switch`` demap/deinterleave/depuncture, soft Viterbi as a
``lax.scan`` trellis), plus :func:`wlan_decode` / :func:`wlan_sync`
convenience wrappers over the same jitted core.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["WLAN_RATES", "wlan_frame_length", "wlan_assemble",
           "wlan_decode", "wlan_sync",
           "WlanSync", "WlanSyncState", "WlanResults", "make_wlan_sync",
           "wlan_sync_init", "wlan_sync_block", "make_wlan_sync_step"]

# rate Mb/s -> (bits/subcarrier BPSC, coding rate (num, den),
#               coded bits/symbol NCBPS, data bits/symbol NDBPS)
WLAN_RATES = {
    6: (1, (1, 2), 48, 24),
    9: (1, (3, 4), 48, 36),
    12: (2, (1, 2), 96, 48),
    18: (2, (3, 4), 96, 72),
    24: (4, (1, 2), 192, 96),
    36: (4, (3, 4), 192, 144),
    48: (6, (2, 3), 288, 192),
    54: (6, (3, 4), 288, 216),
}

_N_FFT = 64
_CP = 16
_DATA_IDX = [k for k in range(-26, 27)
             if k != 0 and abs(k) != 7 and abs(k) != 21]  # 48 carriers
_PILOT_IDX = [-21, -7, 7, 21]


def _fftshift_index(k: int) -> int:
    return k % _N_FFT


@functools.lru_cache(maxsize=None)
def _tables():
    # short training: standard S values on every 4th carrier
    s_set = {
        -24: 1 + 1j, -20: -1 - 1j, -16: 1 + 1j, -12: -1 - 1j, -8: -1 - 1j,
        -4: 1 + 1j, 4: -1 - 1j, 8: -1 - 1j, 12: 1 + 1j, 16: 1 + 1j,
        20: 1 + 1j, 24: 1 + 1j}
    S = np.zeros(_N_FFT, dtype=np.complex128)
    for k, v in s_set.items():
        S[_fftshift_index(k)] = np.sqrt(13.0 / 6.0) * v
    short = np.fft.ifft(S) * _N_FFT / np.sqrt(52)

    # long training: standard L sequence on carriers -26..26
    L_seq = [1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1, 1, 1, -1, -1, 1, 1,
             -1, 1, -1, 1, 1, 1, 1,
             0,
             1, -1, -1, 1, 1, -1, 1, -1, 1, -1, -1, -1, -1, -1, 1, 1, -1,
             -1, 1, -1, 1, -1, 1, 1, 1, 1]
    L = np.zeros(_N_FFT, dtype=np.complex128)
    for i, k in enumerate(range(-26, 27)):
        L[_fftshift_index(k)] = L_seq[i]
    long_t = np.fft.ifft(L) * _N_FFT / np.sqrt(52)

    # pilot polarity PN: the SAME x^7 + x^4 + 1 sequence as the
    # scrambler, seeded all-ones, as +-1 (standard 17.3.5.9)
    pn = 1.0 - 2.0 * _scramble_seq(0x7F).astype(np.float32)
    return short.astype(np.complex64), long_t.astype(np.complex64), \
        pn.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _scramble_seq(seed: int) -> np.ndarray:
    """One period (127 bits) of the x^7 + x^4 + 1 scrambler output."""
    state = seed & 0x7F
    seq = np.empty(127, np.uint8)
    for i in range(127):
        s = ((state >> 6) ^ (state >> 3)) & 1
        seq[i] = s
        state = ((state << 1) | s) & 0x7F
    return seq


def _scramble_bits(bits: np.ndarray, seed: int = 0x5D) -> np.ndarray:
    """Frame-synchronous scrambler x^7 + x^4 + 1 (vectorized: the output
    sequence is data-independent and 127-periodic)."""
    seq = _scramble_seq(seed)
    reps = -(-len(bits) // 127)
    return bits ^ np.tile(seq, reps)[: len(bits)]


# taps[j] multiplies b[i-j].  The 802.11a generators g0=133, g1=171
# (IEEE 802.11-1999 17.3.5.5) are written MSB = delay 0, so tap j is
# polynomial bit (6-j): delays {0,2,3,5,6} and {0,1,2,3,6}.  (Reading
# the octal LSB-first yields the reciprocal code — self-consistent in
# loopback but not wire-compatible with compliant equipment.)
_G0_TAPS = np.array([(0o133 >> (6 - j)) & 1 for j in range(7)], np.uint8)
_G1_TAPS = np.array([(0o171 >> (6 - j)) & 1 for j in range(7)], np.uint8)


def _conv_encode_bits(bits: np.ndarray) -> np.ndarray:
    """K=7 (133, 171) rate-1/2; zero-state start (tail bits included by
    the caller).  Vectorized: each output is a GF(2) convolution."""
    b = np.asarray(bits, np.uint8)
    o0 = np.convolve(b, _G0_TAPS)[: len(b)] & 1
    o1 = np.convolve(b, _G1_TAPS)[: len(b)] & 1
    out = np.empty(2 * len(b), np.uint8)
    out[0::2] = o0
    out[1::2] = o1
    return out


def _puncture(bits: np.ndarray, num: int, den: int) -> np.ndarray:
    if (num, den) == (1, 2):
        return bits
    if (num, den) == (2, 3):
        # keep pattern per 4 coded bits: [1 1 1 0]
        keep = np.tile([1, 1, 1, 0], len(bits) // 4 + 1)[: len(bits)]
    elif (num, den) == (3, 4):
        # keep pattern per 6: [1 1 1 0 0 1]
        keep = np.tile([1, 1, 1, 0, 0, 1], len(bits) // 6 + 1)[: len(bits)]
    else:
        raise ValueError((num, den))
    return bits[keep.astype(bool)]


@functools.lru_cache(maxsize=None)
def _interleave_perm(ncbps: int, bpsc: int) -> np.ndarray:
    """perm[k] = output position of input bit k (17.3.5.6 two-step)."""
    s = max(bpsc // 2, 1)
    k = np.arange(ncbps)
    i = (ncbps // 16) * (k % 16) + k // 16
    j = s * (i // s) + (i + ncbps - (16 * i // ncbps)) % s
    return j


def _interleave(bits: np.ndarray, ncbps: int, bpsc: int) -> np.ndarray:
    """Per-symbol two-permutation block interleaver (vectorized scatter)."""
    perm = _interleave_perm(ncbps, bpsc)
    sym = bits.reshape(-1, ncbps)
    out = np.empty_like(sym)
    out[:, perm] = sym
    return out.reshape(-1)


def _deinterleave(bits: np.ndarray, ncbps: int, bpsc: int) -> np.ndarray:
    perm = _interleave_perm(ncbps, bpsc)
    sym = bits.reshape(-1, ncbps)
    return sym[:, perm].reshape(-1)


def _map_bits(bits: np.ndarray, bpsc: int) -> np.ndarray:
    """Standard 802.11a gray constellation mapping."""
    n = len(bits) // bpsc
    b = bits.reshape(n, bpsc)
    if bpsc == 1:
        return (2.0 * b[:, 0] - 1.0).astype(np.complex64)
    if bpsc == 2:
        return ((2.0 * b[:, 0] - 1) + 1j * (2.0 * b[:, 1] - 1)) / np.sqrt(2)
    if bpsc == 4:
        lut = np.array([-3, -1, 3, 1], dtype=np.float64)
        re = lut[b[:, 0] * 2 + b[:, 1]]
        im = lut[b[:, 2] * 2 + b[:, 3]]
        return ((re + 1j * im) / np.sqrt(10)).astype(np.complex64)
    if bpsc == 6:
        lut = np.array([-7, -5, -1, -3, 7, 5, 1, 3], dtype=np.float64)
        re = lut[b[:, 0] * 4 + b[:, 1] * 2 + b[:, 2]]
        im = lut[b[:, 3] * 4 + b[:, 4] * 2 + b[:, 5]]
        return ((re + 1j * im) / np.sqrt(42)).astype(np.complex64)
    raise ValueError(bpsc)


def _symbols_to_time(freq_syms: np.ndarray) -> np.ndarray:
    """[n_sym, 64] freq grids -> [n_sym * 80] time samples with CP."""
    time = np.fft.ifft(freq_syms, axis=-1) * _N_FFT / np.sqrt(52)
    with_cp = np.concatenate([time[:, -_CP:], time], axis=-1)
    return with_cp.reshape(-1).astype(np.complex64)


def wlan_n_symbols(rate: int, length: int) -> int:
    ndbps = WLAN_RATES[rate][3]
    return -(-(16 + 8 * length + 6) // ndbps)


def wlan_frame_length(rate: int, length: int) -> int:
    """Total samples: short(160) + long(160) + SIGNAL(80) + data syms*80."""
    return 160 + 160 + 80 + wlan_n_symbols(rate, length) * 80


@functools.lru_cache(maxsize=None)
def _assemble_consts(rate: int, length: int, seed: int):
    """Host-precomputed static tables for one (rate, length, seed) frame
    geometry: preambles, the SIGNAL symbol grid (depends only on rate +
    length), scramble PN, puncture keep-indices, interleaver permutation,
    constellation LUTs, and the pilot grid — NumPy, so the jitted
    assemble converts at trace time (closure-constant rule)."""
    bpsc, (num, den), ncbps, ndbps = WLAN_RATES[rate]
    short, long_t, pilot_pn = _tables()

    short_pre = np.tile(short[:16], 10)                    # 160 samples
    long_pre = np.concatenate([long_t[-32:], long_t, long_t])  # 160

    # --- SIGNAL field: 24 bits, BPSK r=1/2, own symbol (static) ---
    rate_bits = list(_RATE_CODES[rate])
    len_bits = [(length >> i) & 1 for i in range(12)]      # LSB first
    sig = np.array(rate_bits + [0] + len_bits, dtype=np.uint8)
    parity = int(sig.sum()) & 1
    sig = np.concatenate([sig, [parity], np.zeros(6, np.uint8)])
    sig_coded = _conv_encode_bits(sig)                     # 48 bits
    sig_inter = _interleave(sig_coded, 48, 1)
    sig_pts = _map_bits(sig_inter, 1)

    n_sym = wlan_n_symbols(rate, length)
    n_data_bits = n_sym * ndbps
    # scramble PN over the data-bit span; tail bits zeroed AFTER
    # scrambling (standard 17.3.5.2) — fold that into a static mask
    pn = np.tile(_scramble_seq(seed),
                 -(-n_data_bits // 127))[:n_data_bits].astype(np.uint8)
    tail_at = 16 + 8 * length
    keep_mask = np.ones(n_data_bits, np.uint8)
    keep_mask[tail_at:tail_at + 6] = 0
    # puncture keep-indices (static gather) per 17.3.5.5
    coded_len = 2 * n_data_bits
    if (num, den) == (1, 2):
        punct_idx = np.arange(coded_len)
    else:
        pat = [1, 1, 1, 0] if (num, den) == (2, 3) else [1, 1, 1, 0, 0, 1]
        keep = np.tile(pat, coded_len // len(pat) + 1)[:coded_len]
        punct_idx = np.nonzero(keep)[0]
    perm = _interleave_perm(ncbps, bpsc)
    inv_perm = np.argsort(perm)     # out[:, perm] = in  <=>  out = in[:, inv]

    # constellation LUTs indexed by the bpsc-bit group value (MSB-first)
    if bpsc == 1:
        lut_re = np.array([-1.0, 1.0], np.float32)
        lut_im = np.zeros(2, np.float32)
    elif bpsc == 2:
        v = np.array([-1.0, 1.0]) / np.sqrt(2)
        lut_re = np.repeat(v, 2).astype(np.float32)        # b0 -> re
        lut_im = np.tile(v, 2).astype(np.float32)          # b1 -> im
    elif bpsc == 4:
        a = np.array([-3, -1, 3, 1]) / np.sqrt(10)
        lut_re = np.repeat(a, 4).astype(np.float32)
        lut_im = np.tile(a, 4).astype(np.float32)
    else:
        a = np.array([-7, -5, -1, -3, 7, 5, 1, 3]) / np.sqrt(42)
        lut_re = np.repeat(a, 8).astype(np.float32)
        lut_im = np.tile(a, 8).astype(np.float32)

    didx = np.array([_fftshift_index(k) for k in _DATA_IDX])
    pidx = np.array([_fftshift_index(k) for k in _PILOT_IDX])
    sig_grid = np.zeros(_N_FFT, np.complex64)
    sig_grid[didx] = sig_pts
    sig_grid[pidx] = np.array([1, 1, 1, -1]) * pilot_pn[0]
    pilot_grid = np.zeros((n_sym, _N_FFT), np.complex64)
    pilot_grid[:, pidx] = (np.array([1, 1, 1, -1])[None, :] *
                           pilot_pn[(1 + np.arange(n_sym)) % 127][:, None])
    # 64-point DFT matrix for the planar-friendly IFFT-as-matmul:
    # grid [.., 64] @ Winv == ifft(grid) (Winv symmetric)
    k = np.arange(_N_FFT)
    Winv = (np.exp(2j * np.pi * np.outer(k, k) / _N_FFT) / _N_FFT) \
        .astype(np.complex64)
    return dict(bpsc=bpsc, n_sym=n_sym, ndbps=ndbps, ncbps=ncbps,
                short_pre=short_pre.astype(np.complex64),
                long_pre=long_pre.astype(np.complex64),
                pn=pn, keep_mask=keep_mask, punct_idx=punct_idx,
                inv_perm=inv_perm, lut_re=lut_re, lut_im=lut_im,
                didx=didx, sig_grid=sig_grid, pilot_grid=pilot_grid,
                Winv=Winv)


def _unpack_bits_lsb(data: jnp.ndarray) -> jnp.ndarray:
    """uint8 bytes ``[n]`` -> bits ``[n*8]``, LSB first (the 802.11a PSDU
    bit order, unlike the MSB-first house codec)."""
    shifts = jnp.arange(0, 8, dtype=jnp.uint8)
    bits = (data[:, None] >> shifts) & jnp.uint8(1)
    return bits.reshape(-1)


def _assemble_traced(rate: int, length: int, seed: int,
                     psdu: jnp.ndarray) -> jnp.ndarray:
    """Jit-traceable DATA-path assemble (static rate/length geometry).

    Runs on-device in the house style: scramble/tail-mask as one XOR+AND
    against static PN, the K=7 convolutional encoder as five shifted-XOR
    streams, puncture/interleave as static gathers, constellation map as
    LUT gathers, and the 64-point IFFT as one [n_sym+1, 64] matmul
    against the DFT matrix (matmul-shaped; also what the planar transform
    would produce, so complex-rejecting backends lower it unchanged)."""
    c = _assemble_consts(rate, length, seed)
    n_data_bits = c["n_sym"] * c["ndbps"]
    bits = _unpack_bits_lsb(psdu.astype(jnp.uint8))
    data = jnp.concatenate([
        jnp.zeros(16, jnp.uint8), bits,
        jnp.zeros(n_data_bits - 16 - 8 * length, jnp.uint8)])
    scrambled = (data ^ jnp.asarray(c["pn"])) & jnp.asarray(c["keep_mask"])
    # K=7 (133, 171) rate-1/2: XOR of delayed streams per generator
    # (delays {0,2,3,5,6} and {0,1,2,3,6}; zero state start)
    def delayed(b, d):
        return jnp.pad(b, (d, 0))[:n_data_bits] if d else b
    o0 = scrambled
    for d in (2, 3, 5, 6):
        o0 = o0 ^ delayed(scrambled, d)
    o1 = scrambled
    for d in (1, 2, 3, 6):
        o1 = o1 ^ delayed(scrambled, d)
    coded = jnp.stack([o0, o1], axis=-1).reshape(-1)       # interleaved A/B
    punct = coded[jnp.asarray(c["punct_idx"])]
    inter = punct.reshape(c["n_sym"], c["ncbps"])[
        :, jnp.asarray(c["inv_perm"])]
    # bpsc-bit groups (MSB-first) -> LUT index -> constellation point
    bpsc = c["bpsc"]
    grp = inter.reshape(-1, bpsc).astype(jnp.int32)
    w = jnp.asarray(1 << np.arange(bpsc - 1, -1, -1, dtype=np.int32))
    idx = jnp.sum(grp * w, axis=-1)
    pts = (jnp.asarray(c["lut_re"])[idx]
           + 1j * jnp.asarray(c["lut_im"])[idx]).astype(jnp.complex64)

    grids = jnp.asarray(c["pilot_grid"])
    grids = grids.at[:, jnp.asarray(c["didx"])].set(
        pts.reshape(c["n_sym"], 48))
    grids = jnp.concatenate([jnp.asarray(c["sig_grid"])[None, :], grids])
    # IFFT as one DFT matmul + CP via slicing (scale 64/sqrt(52) folds
    # the module power normalization, as in _symbols_to_time)
    # HIGHEST: the TX waveform must match the Annex-G goldens, which
    # TF32's ~3 decimal digits would not
    time = jnp.matmul(grids, jnp.asarray(c["Winv"]),
                      precision=jax.lax.Precision.HIGHEST) * \
        jnp.complex64(_N_FFT / np.sqrt(52))
    with_cp = jnp.concatenate([time[:, -_CP:], time], axis=-1)
    return jnp.concatenate([
        jnp.asarray(c["short_pre"]), jnp.asarray(c["long_pre"]),
        with_cp.reshape(-1)]).astype(jnp.complex64)


@functools.lru_cache(maxsize=None)
def _assemble_jit(rate: int, length: int, seed: int):
    return jax.jit(functools.partial(_assemble_traced, rate, length, seed))


def wlan_assemble(rate: int, psdu: np.ndarray,
                  seed: int = 0x5D) -> jnp.ndarray:
    """Assemble one 802.11a frame -> complex64 ``[wlan_frame_length]``.

    ``rate``: 6/9/12/18/24/36/48/54 Mb/s; ``psdu``: payload bytes.
    Jitted on-device in the house style (one compile per (rate, length)
    geometry); the reference app's TX object is host-side liquid-wlan
    (/root/reference/src/wlanframe_tx.cc:174-231).
    """
    if rate not in WLAN_RATES:
        raise ValueError(f"invalid rate {rate}; one of {list(WLAN_RATES)}")
    psdu = jnp.asarray(psdu, dtype=jnp.uint8)
    return _assemble_jit(rate, int(psdu.shape[-1]), seed)(psdu)




# ---------------------------------------------------------------------------
# RX — jitted streaming synchronizer (house style: step(state, block))
# ---------------------------------------------------------------------------
#
# The reference's liquid-wlan is TX-only; this receive path exists for
# loopback verification and completeness, built like the other frame
# families (ofdm_sync/flexframe_sync/gmskframe): static shapes, segmented
# cross-correlation detection, one gated vmapped candidate decode per
# block, soft Viterbi as a lax.scan trellis.

_DET_SEG = 8        # detection segment length (coherent span; CFO-robust
#                     to ~1.2 rad over a segment at the 0.196 spec edge)
_DET_NSEG = 16      # 16 segments x 8 = the full 128-sample [LT1 LT2]
_DET_WIN = 96       # NMS radius > the 64-sample LT self-similarity lobe

_RATE_LIST = tuple(sorted(WLAN_RATES))          # (6, 9, ..., 54)
_RATE_CODES = {6: (1, 1, 0, 1), 9: (1, 1, 1, 1), 12: (0, 1, 0, 1),
               18: (0, 1, 1, 1), 24: (1, 0, 0, 1), 36: (1, 0, 1, 1),
               48: (0, 0, 0, 1), 54: (0, 0, 1, 1)}


class WlanSync(NamedTuple):
    block_size: int
    max_psdu: int           # static PSDU decode budget (bytes)
    max_frames: int         # candidates per block
    threshold: float
    overlap: int            # carried tail (>= max frame + margins)
    max_sym: int            # static DATA symbol budget
    nb: int                 # static Viterbi data-bit budget
    w_frame: int            # static frame window (400 + max_sym*80)


class WlanSyncState(NamedTuple):
    tail: jnp.ndarray       # [overlap] complex64
    base: jnp.ndarray       # int32 stream index of tail[0]


class WlanResults(NamedTuple):
    """Fixed-shape per-block results; leading dim = max_frames."""
    detected: jnp.ndarray      # bool
    signal_valid: jnp.ndarray  # bool
    psdu_valid: jnp.ndarray    # bool
    rate: jnp.ndarray          # int32 Mb/s (0 when invalid)
    length: jnp.ndarray        # int32 PSDU bytes
    psdu: jnp.ndarray          # [max_frames, max_psdu] uint8
    cfo: jnp.ndarray           # float32 rad/sample
    rssi: jnp.ndarray          # float32 dB
    t_start: jnp.ndarray       # int32 stream index of the frame's first
    #                            short-training sample


def make_wlan_sync(block_size: int = 8192, max_psdu: int = 256,
                   max_frames: int = 4,
                   threshold: float = 0.45) -> WlanSync:
    # worst-case symbol count is the lowest rate (24 data bits/symbol)
    max_sym = -(-(16 + 8 * max_psdu + 6) // 24)
    # static data-bit budget: covers n_sym*ndbps for EVERY rate at
    # length <= max_psdu (pad bits bounded by ndbps_max - 1 = 215)
    nb = 16 + 8 * max_psdu + 6 + 216
    w_frame = 400 + max_sym * 80
    return WlanSync(block_size=block_size, max_psdu=max_psdu,
                    max_frames=max_frames, threshold=threshold,
                    overlap=w_frame + 192 + 256, max_sym=max_sym,
                    nb=nb, w_frame=w_frame)


def wlan_sync_init(sync: WlanSync) -> WlanSyncState:
    return WlanSyncState(tail=jnp.zeros((sync.overlap,), jnp.complex64),
                         base=jnp.int32(-sync.overlap))


@functools.lru_cache(maxsize=None)
def _det_templates():
    """Segmented [LT1 LT2] templates ``[_DET_NSEG, _DET_SEG]`` (conj)
    and per-segment energies."""
    _, long_t, _ = _tables()
    lt = np.concatenate([long_t, long_t])            # 128 samples
    segs = lt.reshape(_DET_NSEG, _DET_SEG)
    E = np.sum(np.abs(segs) ** 2, axis=-1).astype(np.float32)
    return np.conj(segs).astype(np.complex64), E


def _wlan_metric(sync: WlanSync, ext: jnp.ndarray) -> jnp.ndarray:
    """Segmented-coherent LT cross-correlation metric over the detect
    region ``[0, block + 2*_DET_WIN)`` (peak = LT1 start, value ~1)."""
    tmpl, E = _det_templates()
    R = sync.block_size + 2 * _DET_WIN
    L = R + _DET_SEG * (_DET_NSEG - 1) + _DET_SEG    # samples touched
    x = ext[:L]
    win = x[jnp.arange(L - _DET_SEG + 1)[:, None] +
            jnp.arange(_DET_SEG)[None, :]]           # [L-7, 8]
    C = jnp.matmul(win, jnp.asarray(tmpl).T,
                   precision=jax.lax.Precision.HIGHEST)  # [L-7, 16]
    e8 = jnp.convolve(jnp.abs(x) ** 2, jnp.ones(_DET_SEG), "valid")
    rows = jnp.arange(R)[:, None] + _DET_SEG * jnp.arange(_DET_NSEG)
    c = C[rows, jnp.arange(_DET_NSEG)[None, :]]      # [R, 16]
    e = e8[rows]
    nc = jnp.abs(c) ** 2 / jnp.maximum(e * jnp.asarray(E), 1e-12)
    metric = jnp.mean(nc, axis=-1)
    # silence gate: require real energy under the template
    floor = 1e-4 * _DET_NSEG * _DET_SEG * (jnp.mean(jnp.abs(x) ** 2)
                                           + 1e-12)
    return jnp.where(jnp.sum(e, axis=-1) > floor, metric, 0.0)


def _find_candidates_wlan(sync: WlanSync, metric: jnp.ndarray):
    from .ofdm_sync import topk_peaks
    T = sync.block_size
    win = _DET_WIN
    from ..ops.corr import sliding_max
    local_max = sliding_max(metric, win)
    is_peak = (metric >= local_max) & (metric > sync.threshold)
    idx = jnp.arange(metric.shape[0])
    score = jnp.where(is_peak & (idx >= win) & (idx < T + win),
                      metric, -1.0)
    vals, locs = topk_peaks(score, sync.max_frames, 2 * win + 1)
    return vals > 0, locs


@functools.lru_cache(maxsize=None)
def _vit_tables():
    """Predecessor tables for the K=7 (133,171) trellis.

    Register convention: ``reg = (b << 6) | s`` with ``s`` holding
    ``b[i-1]..b[i-6]`` (bit 5..0), so output j = parity(reg & g_j) with
    the generator octals used directly, and ``next = reg >> 1`` — the
    exact dual of :func:`_conv_encode_bits`.
    """
    S = 64
    pred = np.zeros((S, 2), np.int32)
    pred_bit = np.zeros((S, 2), np.uint8)
    out = np.zeros((S, 2, 2), np.float32)
    cnt = np.zeros(S, np.int32)
    for s in range(S):
        for b in (0, 1):
            reg = (b << 6) | s
            out[s, b, 0] = 2.0 * (bin(reg & 0o133).count("1") & 1) - 1.0
            out[s, b, 1] = 2.0 * (bin(reg & 0o171).count("1") & 1) - 1.0
            ns = reg >> 1
            pred[ns, cnt[ns]] = s
            pred_bit[ns, cnt[ns]] = b
            cnt[ns] += 1
    assert (cnt == 2).all()
    bm = out[pred, pred_bit]                         # [S, 2, 2]
    return pred, pred_bit, bm[..., 0].copy(), bm[..., 1].copy()


def _viterbi_soft(llr_pairs: jnp.ndarray) -> jnp.ndarray:
    """Soft Viterbi for the zero-state-started K=7 (133,171) code.

    ``llr_pairs [n, 2]`` float (positive => coded bit 1, 0 = erasure);
    free end state (erasure tails leave the live prefix exactly ML).
    Returns decoded bits ``[n]`` uint8.  lax.scan trellis: all 64 states
    advance as one vector op per step.
    """
    pred_np, pred_bit_np, bm0_np, bm1_np = _vit_tables()
    pred = jnp.asarray(pred_np)
    pred_bit = jnp.asarray(pred_bit_np)
    bm0 = jnp.asarray(bm0_np)
    bm1 = jnp.asarray(bm1_np)
    pm0 = jnp.full((64,), -1e9, jnp.float32).at[0].set(0.0)

    def step(pm, rx):
        m = pm[pred] + rx[0] * bm0 + rx[1] * bm1     # [64, 2]
        choice = jnp.argmax(m, axis=-1)
        pm_n = jnp.take_along_axis(m, choice[:, None], axis=-1)[:, 0]
        pm_n = pm_n - jnp.max(pm_n)
        return pm_n, choice.astype(jnp.uint8)

    pm, choices = jax.lax.scan(step, pm0, llr_pairs)
    s0 = jnp.argmax(pm).astype(jnp.int32)

    def back(state, choice_t):
        w = choice_t[state]
        return pred[state, w], pred_bit[state, w]

    _, bits = jax.lax.scan(back, s0, choices, reverse=True)
    return bits


def _axis_llr_jax(x: jnp.ndarray, levels: np.ndarray,
                  nbits: int) -> jnp.ndarray:
    """Max-log per-bit soft metrics for one gray-coded PAM axis
    (``levels[idx]`` = amplitude for axis-bit index ``idx``, the
    :func:`_map_bits` layout).  ``[n] -> [n, nbits]``; positive => 1."""
    lv = jnp.asarray(levels, jnp.float32)
    d = (x[:, None] - lv[None, :]) ** 2
    idx = np.arange(len(levels))
    outs = []
    for t in range(nbits):
        bit = (idx >> (nbits - 1 - t)) & 1
        d0 = jnp.min(jnp.where(jnp.asarray(bit == 0), d, jnp.inf), axis=-1)
        d1 = jnp.min(jnp.where(jnp.asarray(bit == 1), d, jnp.inf), axis=-1)
        outs.append(d0 - d1)
    return jnp.stack(outs, axis=-1)


def _demap_soft_jax(pts: jnp.ndarray, bpsc: int) -> jnp.ndarray:
    """Equalized points ``[n]`` -> per-bit LLRs ``[n, bpsc]``."""
    if bpsc == 1:
        return 2.0 * pts.real[:, None]
    if bpsc == 2:
        s = np.sqrt(2.0)
        return jnp.stack([pts.real * s, pts.imag * s], axis=-1)
    if bpsc == 4:
        lut = np.array([-3, -1, 3, 1]) / np.sqrt(10)
        return jnp.concatenate([_axis_llr_jax(pts.real, lut, 2),
                                _axis_llr_jax(pts.imag, lut, 2)], axis=-1)
    if bpsc == 6:
        lut = np.array([-7, -5, -1, -3, 7, 5, 1, 3]) / np.sqrt(42)
        return jnp.concatenate([_axis_llr_jax(pts.real, lut, 3),
                                _axis_llr_jax(pts.imag, lut, 3)], axis=-1)
    raise ValueError(bpsc)


@functools.lru_cache(maxsize=None)
def _depuncture_pos(num: int, den: int, ndbps: int) -> np.ndarray:
    """Static within-symbol scatter: kept-LLR index -> position in the
    symbol's ``2*ndbps`` rate-1/2 coded slots."""
    pattern = {(1, 2): [1], (2, 3): [1, 1, 1, 0],
               (3, 4): [1, 1, 1, 0, 0, 1]}[(num, den)]
    keep = np.tile(pattern, 2 * ndbps // len(pattern) + 1)[: 2 * ndbps]
    return np.nonzero(keep)[0].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _descr_tables():
    """(master 127-bit sequence, phase[state] offset table) for the
    self-synchronizing descrambler: the output sequence from any nonzero
    7-bit state is a cyclic shift of the single maximal-length sequence."""
    master = _scramble_seq(0x7F)
    phase = np.zeros(128, np.int32)
    state = 0x7F
    for i in range(127):
        phase[state] = i
        s = ((state >> 6) ^ (state >> 3)) & 1
        state = ((state << 1) | s) & 0x7F
    return master, phase


def _make_rate_branch(sync: WlanSync, rate: int):
    """DATA demap/deinterleave/depuncture branch for one static rate:
    ``(Yd [max_sym, 48], length) -> (llr_pairs [nb, 2], live_bits)``."""
    bpsc, (num, den), ncbps, ndbps = WLAN_RATES[rate]
    perm = _interleave_perm(ncbps, bpsc)
    kept = _depuncture_pos(num, den, ndbps)

    def fn(args):
        Yd, length = args
        llr = _demap_soft_jax(Yd.reshape(-1), bpsc)      # [ms*48, bpsc]
        llr = llr.reshape(sync.max_sym, ncbps)
        llr = llr[:, jnp.asarray(perm)]                  # deinterleave
        coded = jnp.zeros((sync.max_sym, 2 * ndbps), jnp.float32)
        coded = coded.at[:, jnp.asarray(kept)].set(llr)
        flat = coded.reshape(-1)
        total = 2 * sync.nb
        if flat.shape[0] >= total:
            flat = flat[:total]
        else:
            flat = jnp.pad(flat, (0, total - flat.shape[0]))
        n_sym = (16 + 8 * length + 6 + ndbps - 1) // ndbps
        live = jnp.minimum(n_sym * ndbps, sync.nb).astype(jnp.int32)
        return flat.reshape(sync.nb, 2), live
    return fn


def _decode_candidate_wlan(sync: WlanSync, ext: jnp.ndarray,
                           n0: jnp.ndarray):
    """Refine + decode one candidate (``n0`` = LT1 start in ext)."""
    W = sync.w_frame
    start = jnp.maximum(n0 - 192, 0)
    idx = jnp.clip(start + jnp.arange(W), 0, ext.shape[0] - 1)
    w = ext[idx]
    scale = _N_FFT / np.sqrt(52)
    _, long_t, pilot_pn = _tables()
    didx = np.array([_fftshift_index(k) for k in _DATA_IDX])
    pidx = np.array([_fftshift_index(k) for k in _PILOT_IDX])

    # two-stage CFO: coarse from the ST lag-16 products, fine from the
    # LT lag-64 product (coarse residual well inside +-pi/64)
    c16 = jnp.sum(w[48:160] * jnp.conj(w[32:144]))
    cfo_c = jnp.angle(c16) / 16.0
    t = jnp.arange(W, dtype=jnp.float32)
    w1 = w * jnp.exp(-1j * cfo_c * t)
    c64 = jnp.sum(w1[256:320] * jnp.conj(w1[192:256]))
    cfo = cfo_c + jnp.angle(c64) / 64.0
    w = w * jnp.exp(-1j * cfo * t)

    # channel estimate from the two long-training symbols
    L_ref = np.fft.fft(np.asarray(long_t)) / scale
    act = np.abs(L_ref) > 0.1
    L1 = jnp.fft.fft(w[192:256]) / scale
    L2 = jnp.fft.fft(w[256:320]) / scale
    H = jnp.where(jnp.asarray(act),
                  (L1 + L2) / 2.0 * jnp.asarray(np.conj(L_ref) /
                  np.maximum(np.abs(L_ref) ** 2, 1e-12)), 1.0)
    Hsafe = jnp.where(jnp.abs(H) > 1e-6, H, 1.0)

    # all symbols (SIGNAL + max_sym DATA): batched FFT + EQ + pilot CPE
    sym_i = 336 + 80 * jnp.arange(1 + sync.max_sym)[:, None] + \
        jnp.arange(_N_FFT)[None, :]
    Y = jnp.fft.fft(w[sym_i], axis=-1) / scale
    Yeq = Y / Hsafe[None, :]
    ppol = np.array([1.0, 1.0, 1.0, -1.0], np.float32)
    pref = (ppol[None, :] *
            np.asarray(pilot_pn)[np.arange(1 + sync.max_sym) % 127][:, None])
    rot = jnp.mean(Yeq[:, jnp.asarray(pidx)] * jnp.asarray(pref), axis=-1)
    rot = rot / jnp.maximum(jnp.abs(rot), 1e-12)
    Yeq = Yeq * jnp.conj(rot)[:, None]

    # SIGNAL: BPSK r=1/2, own interleaver, 24 decoded bits
    sig_llr = 2.0 * Yeq[0, jnp.asarray(didx)].real
    sig_llr = sig_llr[jnp.asarray(_interleave_perm(48, 1))]
    sig_bits = _viterbi_soft(sig_llr.reshape(24, 2))
    codes = np.array([_RATE_CODES[r] for r in _RATE_LIST], np.uint8)
    eq = jnp.all(sig_bits[None, :4] == jnp.asarray(codes), axis=-1)
    rate_found = jnp.any(eq)
    rate_idx = jnp.argmax(eq).astype(jnp.int32)
    length = jnp.sum(sig_bits[5:17].astype(jnp.int32) <<
                     jnp.arange(12, dtype=jnp.int32))
    parity_ok = (jnp.sum(sig_bits[:17]).astype(jnp.int32) & 1) == \
        sig_bits[17].astype(jnp.int32)
    sig_ok = (rate_found & parity_ok & (length > 0) & (length <= 4095)
              & ~jnp.any(sig_bits[18:24]))
    length = jnp.clip(length, 0, 4095)

    # DATA: rate lax.switch -> static [nb, 2] LLR pairs + live mask
    branches = [_make_rate_branch(sync, r) for r in _RATE_LIST]
    pairs, live = jax.lax.switch(rate_idx, branches,
                                 (Yeq[1:, jnp.asarray(didx)], length))
    pairs = jnp.where(jnp.arange(sync.nb)[:, None] < live, pairs, 0.0)
    scrambled = _viterbi_soft(pairs)                 # [nb]

    # self-synchronizing descramble via the phase-offset table
    master, phase = _descr_tables()
    st7 = jnp.sum(scrambled[:7].astype(jnp.int32) <<
                  jnp.arange(6, -1, -1, dtype=jnp.int32))
    ph = jnp.asarray(phase)[st7]
    seq = jnp.asarray(master)[(ph + jnp.arange(sync.nb - 7)) % 127]
    seq = jnp.where(st7 == 0, 0, seq).astype(jnp.uint8)
    data = jnp.concatenate(
        [jnp.zeros(7, jnp.uint8), scrambled[7:] ^ seq])

    # PSDU bytes (LSB-first bit order, mirroring the TX unpack)
    pb = data[16:16 + 8 * sync.max_psdu]
    pb = pb * (jnp.arange(8 * sync.max_psdu) < 8 * length)
    psdu = jnp.sum(pb.reshape(sync.max_psdu, 8).astype(jnp.int32) <<
                   jnp.arange(8, dtype=jnp.int32)[None, :],
                   axis=-1).astype(jnp.uint8)

    # DATA validity: the post-scramble-zeroed tail bits must decode zero
    tail_i = jnp.clip(16 + 8 * length + jnp.arange(6), 0, sync.nb - 1)
    tail_ok = ~jnp.any(scrambled[tail_i])
    psdu_ok = sig_ok & tail_ok & (length <= sync.max_psdu)

    rate_val = jnp.asarray(np.array(_RATE_LIST, np.int32))[rate_idx]
    rssi = 10.0 * jnp.log10(jnp.maximum(
        jnp.mean(jnp.abs(ext[jnp.clip(start + jnp.arange(160), 0,
                                      ext.shape[0] - 1)]) ** 2), 1e-12))
    return (sig_ok, psdu_ok, jnp.where(sig_ok, rate_val, 0),
            jnp.where(sig_ok, length, 0), psdu, cfo, rssi)


def _gated_decode_wlan(sync: WlanSync, ext: jnp.ndarray, gate,
                       locs: jnp.ndarray):
    R = locs.shape[0]

    def do_decode(locs_):
        return jax.vmap(lambda n0: _decode_candidate_wlan(sync, ext,
                                                          n0))(locs_)

    def skip_decode(locs_):
        f32 = jnp.float32
        return (jnp.zeros((R,), bool), jnp.zeros((R,), bool),
                jnp.zeros((R,), jnp.int32), jnp.zeros((R,), jnp.int32),
                jnp.zeros((R, sync.max_psdu), jnp.uint8),
                jnp.zeros((R,), f32), jnp.zeros((R,), f32))

    return jax.lax.cond(gate, do_decode, skip_decode, locs)


def wlan_sync_block(sync: WlanSync, state: WlanSyncState,
                    block: jnp.ndarray):
    """Process ``block_size`` samples -> (state', WlanResults)."""
    from ..ops import iqfmt
    block = iqfmt.iq_from_any(block)
    ext = jnp.concatenate([state.tail, block])
    metric = _wlan_metric(sync, ext)
    detected, locs = _find_candidates_wlan(sync, metric)
    (sig_ok, psdu_ok, rate, length, psdu, cfo,
     rssi) = _gated_decode_wlan(sync, ext, jnp.any(detected), locs)
    res = WlanResults(
        detected=detected,
        signal_valid=detected & sig_ok,
        psdu_valid=detected & psdu_ok,
        rate=rate, length=length, psdu=psdu, cfo=cfo, rssi=rssi,
        t_start=state.base + locs.astype(jnp.int32) - 192,
    )
    new_state = WlanSyncState(
        tail=ext[ext.shape[0] - sync.overlap:],
        base=state.base + sync.block_size)
    return new_state, res


def make_wlan_sync_step(sync: WlanSync):
    @jax.jit
    def step(state, block):
        return wlan_sync_block(sync, state, block)
    return step


# ---------------------------------------------------------------------------
# convenience wrappers over the jitted core (historic API)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _decode_jit(max_psdu: int):
    sync = make_wlan_sync(max_psdu=max_psdu)

    @jax.jit
    def run(ext):
        return _decode_candidate_wlan(sync, ext, jnp.int32(192))
    return sync, run


def wlan_decode(samples: np.ndarray, max_psdu: int = 4095) -> dict:
    """Decode one 802.11a frame whose preamble starts at ``samples[0]``
    (jitted core; LT channel EQ + pilot tracking + soft Viterbi +
    self-synchronizing descramble).  Returns rate/length/psdu + validity
    flags."""
    samples = np.asarray(samples).astype(np.complex64)
    if len(samples) < 400:
        return {"rate": 0, "length": 0, "signal_valid": False,
                "psdu": None, "psdu_valid": False}
    # static budget: smallest power-of-two tier the frame could need
    # (rate 54 packs the most bytes per symbol)
    n_sym = max((len(samples) - 400) // 80, 1)
    implied = min(max_psdu, (n_sym * 216 - 22) // 8 + 1)
    tier = 64
    while tier < implied:
        tier *= 2
    sync, run = _decode_jit(min(tier, 4095))
    # n0 = 192 = LT1 offset within the frame, so the candidate window
    # (which starts at n0 - 192) begins exactly at samples[0]
    need = sync.w_frame
    ext = np.zeros(need, np.complex64)
    ext[: min(len(samples), need)] = samples[:need]
    (sig_ok, psdu_ok, rate, length, psdu, _cfo,
     _rssi) = jax.tree.map(np.asarray, run(jnp.asarray(ext)))
    out = {"rate": int(rate) if sig_ok else None, "length": int(length),
           "signal_valid": bool(sig_ok), "psdu": None,
           "psdu_valid": False}
    if sig_ok:
        out["psdu"] = psdu[: int(length)]
        out["psdu_valid"] = bool(psdu_ok)
    return out


def wlan_sync(stream: np.ndarray, max_frames: int = 8,
              thresh: float = 0.45, max_psdu: int = 256) -> list:
    """Streaming 802.11a receiver: detect frames anywhere in ``stream``
    (segmented LT cross-correlation), correct CFO (coarse ST lag-16 +
    fine LT lag-64), decode each through the jitted candidate core.

    Returns a list of :func:`wlan_decode`-shaped dicts with added
    ``start`` (sample index of the frame's first ST sample) and ``cfo``
    (radians/sample).  The reference's liquid-wlan has no receiver at
    all; this is the capability its TX side implies.
    """
    x = np.asarray(stream).astype(np.complex64)
    sync = make_wlan_sync(max_psdu=max_psdu, threshold=thresh,
                          max_frames=min(max_frames, 4))
    step = make_wlan_sync_step(sync)
    state = wlan_sync_init(sync)
    bs = sync.block_size
    n_blocks = -(-len(x) // bs) + sync.overlap // bs + 1
    pad = np.zeros(n_blocks * bs - len(x), np.complex64)
    xs = np.concatenate([x, pad])
    results = []
    for b in range(n_blocks):
        state, res = step(state, jnp.asarray(xs[b * bs:(b + 1) * bs]))
        res = jax.tree.map(np.asarray, res)
        for i in np.nonzero(res.detected & res.signal_valid)[0]:
            if len(results) >= max_frames:
                break
            results.append({
                "start": int(res.t_start[i]),
                "cfo": float(res.cfo[i]),
                "rate": int(res.rate[i]),
                "length": int(res.length[i]),
                "signal_valid": True,
                "psdu": res.psdu[i][: int(res.length[i])]
                if res.psdu_valid[i] else None,
                "psdu_valid": bool(res.psdu_valid[i]),
            })
    return sorted(results, key=lambda d: d["start"])
