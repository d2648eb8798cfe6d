"""OFDM flexframe synchronizer (RX) — batched block dataflow.

Capability parity: ``ofdmflexframesync`` — streaming frame detection, coarse
CFO estimation, fine timing, preamble channel equalization, header decode
(-> per-packet payload mod/FEC), payload decode, and per-frame stats
(rssi/evm/cfo) delivered with validity flags (/root/reference/lib/
ofdmtxrx.cc:91,625 runs it one sample at a time; callback shape at
/root/reference/src/ofdmflexframe_rx.cc:43-80).

Block-dataflow redesign (SURVEY.md §7 hard part 1): instead of a samplewise
state machine, the stream is processed in fixed-size blocks with an overlap
of one maximum frame length:

1. **Detect** — the S0 preamble's period-M/4 time structure yields a
   normalized autocorrelation metric computed for *every* offset at once via
   cumulative sums; plateau peaks are extracted with a max-pool
   (``reduce_window``) non-max suppression and ``top_k``.
2. **Refine & decode** (``vmap`` over candidates) — coarse CFO from the
   autocorrelation phase; derotate a max-frame window (one gather); fine
   timing by S1 matched filter; channel estimate from S1; all OFDM symbols
   FFT'd in one batch; pilot common-phase + timing-slope correction per
   symbol; header hard-decoded (static format); payload demodulated with a
   runtime-selected constellation (padded-table gather) and FEC-decoded via
   ``lax.switch`` over the scheme enum on static max-size buffers with
   masked lengths.

Results are fixed-shape arrays with validity masks — the functional
replacement for the reference's callback-from-worker-thread design.
Block-size invariance: every stream offset lands in exactly one block's
detect region, so frame results are independent of the block chopping.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import iqfmt
from ..ops import modem as modem_mod
from . import payload as payload_codec
from .payload import (EXPANSION as _EXPANSION, HEADER_BPS as _HEADER_BPS,
                      HEADER_MOD as _HEADER_MOD, HEADER_SYMS,
                      PAYLOAD_FECS, PAYLOAD_MODS)
from .ofdm import (NUM_S0, OfdmParams, _pilot_values, header_symbol_count)

# payload symbols feeding the decision-directed second-pass channel
# re-estimation (caps the extra |x-c|^2 table pass; 64 symbols already
# push the per-carrier observation count far past the EQ-noise knee)
_DD_SYMS = 64

__all__ = ["OfdmSync", "OfdmSyncState", "FrameResults", "make_sync",
           "sync_init", "sync_block", "debug_capture",
           "PAYLOAD_FECS", "PAYLOAD_MODS"]

class OfdmSync(NamedTuple):
    params: OfdmParams
    block_size: int            # samples consumed per step
    max_payload: int           # static payload decode budget (bytes)
    max_frames: int            # candidates per block
    threshold: float           # detection metric threshold in (0, 1)
    overlap: int               # carried tail length (>= max frame length)
    max_psym: int              # payload OFDM symbols budget
    dec_max: int               # payload + max CRC bytes
    enc_max: int               # encoded payload buffer bytes
    fecs: tuple = PAYLOAD_FECS # runtime-decodable payload FEC set
    soft: bool = False         # soft-decision LLRs into conv FEC branches
    # detection metric: True (default) = segmented-coherent S0
    # cross-correlation (holds ~2-3 dB lower SNR than the Schmidl-Cox
    # autocorrelation, whose lag-product SNR degrades quadratically);
    # False = legacy autocorrelation metric
    xcorr_detect: bool = True
    # second header-decode iteration on the DD-refined channel estimate
    # (recovers marginal Golay blocks at the 0-1 dB waterfall where the
    # header is EQ-noise-limited; measured below)
    iter_header: bool = True


class OfdmSyncState(NamedTuple):
    tail: jnp.ndarray          # [overlap] complex64
    base: jnp.ndarray          # int32: stream index of tail[0]; t_start
    # timestamps inherit its wrap at 2^31 samples (fixed-width counter)


class FrameResults(NamedTuple):
    """Fixed-shape per-block results; all leading dim = max_frames."""
    detected: jnp.ndarray      # bool
    header_valid: jnp.ndarray  # bool
    payload_valid: jnp.ndarray # bool
    header: jnp.ndarray        # [max_frames, 8] uint8
    payload: jnp.ndarray       # [max_frames, max_payload] uint8
    payload_len: jnp.ndarray   # int32
    mod: jnp.ndarray           # int32
    fec0: jnp.ndarray          # int32
    fec1: jnp.ndarray          # int32
    check: jnp.ndarray         # int32
    rssi: jnp.ndarray          # float32 dB
    evm: jnp.ndarray           # float32 dB (header symbols)
    cfo: jnp.ndarray           # float32 rad/sample
    t_start: jnp.ndarray       # int32 stream sample index of S0 start


def make_sync(params: OfdmParams, block_size: int = 16384,
              max_payload: int = 2048, max_frames: int = 8,
              threshold: float = 0.5,
              enable_conv: bool = False, soft: bool = False,
              xcorr_detect: bool = True,
              iter_header: bool = True,
              expansion: int = _EXPANSION) -> OfdmSync:
    if expansion < 1:
        raise ValueError(f"expansion must be >= 1 (got {expansion})")
    M, cp = params.M, params.cp_len
    n_data = len(params.data_idx)
    dec_max = max_payload + 4
    enc_max = expansion * dec_max   # see payload.check_budget
    # +1 point: DPSK payloads lead with a phase-reference point
    max_psym = -(-(enc_max * 8 + 1) // n_data)   # bps >= 1
    n_hsym = header_symbol_count(params)
    max_frame = (NUM_S0 + 1) * M + (n_hsym + max_psym) * (M + cp)
    overlap = max_frame + 4 * M
    fecs = (payload_codec.PAYLOAD_FECS_FULL if enable_conv
            else payload_codec.PAYLOAD_FECS)
    return OfdmSync(params=params, block_size=block_size,
                    max_payload=max_payload, max_frames=max_frames,
                    threshold=threshold, overlap=overlap, max_psym=max_psym,
                    dec_max=dec_max, enc_max=enc_max, fecs=fecs, soft=soft,
                    xcorr_detect=bool(xcorr_detect),
                    iter_header=bool(iter_header))


def sync_init(sync: OfdmSync) -> OfdmSyncState:
    return OfdmSyncState(
        tail=jnp.zeros((sync.overlap,), jnp.complex64),
        base=jnp.int32(-sync.overlap))


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

def _moving_sum(x: jnp.ndarray, L: int) -> jnp.ndarray:
    cs = jnp.concatenate([jnp.zeros((1,), x.dtype), jnp.cumsum(x)])
    return cs[L:] - cs[:-L]


def _detect_metric(sync: OfdmSync, ext: jnp.ndarray):
    """S0 periodicity metric for every offset: ``[len(ext) - span]``.

    metric[n] = |sum_i x[n+i] conj(x[n+i+d])|^2 / (E1 E2), d = M/4,
    summed over the S0 span.  Also returns the raw correlation (CFO phase).
    """
    M = sync.params.M
    d = M // 4
    L = NUM_S0 * M - d
    prod = ext[:-d] * jnp.conj(ext[d:])
    c = _moving_sum(prod, L)
    p = jnp.abs(ext) ** 2
    e1 = _moving_sum(p[:-d], L)
    e2 = _moving_sum(p[d:], L)
    metric = jnp.abs(c) ** 2 / jnp.maximum(e1 * e2, 1e-12)
    # energy floor: a near-silent window must not score via 0/0 (the
    # normalized metric is meaningless without signal energy)
    floor = 1e-4 * L * (jnp.mean(p) + 1e-12)
    metric = jnp.where(jnp.minimum(e1, e2) > floor, metric, 0.0)
    return metric, c


_XC_SEG = 24                    # xcorr coherence-segment length (samples)
_XC_FREQ_CACHE: dict = {}


def _xc_span(n_tmpl: int) -> int:
    """Coherence-segment length: the largest divisor of the template
    length <= _XC_SEG, so every template sample is covered at any M
    (96 -> 24, 128 -> 16, 16 -> 16; a fixed 24 would leave 0 segments
    at M=8 and 8 uncovered samples at M=64)."""
    for span in range(min(_XC_SEG, n_tmpl), 0, -1):
        if n_tmpl % span == 0:
            return span
    return n_tmpl


def _xcorr_freq(params, nfft: int):
    """Host-precomputed frequency responses of the reversed S0 template
    segments (one per coherence segment; see ops.corr.comb_rev_freq_np
    with k=1) plus the per-segment template energies."""
    key = (params.s0_time.tobytes(), nfft)
    hit = _XC_FREQ_CACHE.get(key)
    if hit is None:
        from ..ops.corr import comb_rev_freq_np
        tmpl = np.tile(params.s0_time, NUM_S0)
        span = _xc_span(len(tmpl))
        n_seg = len(tmpl) // span
        Gs = np.stack([
            comb_rev_freq_np(np.conj(tmpl[s * span:(s + 1) * span]),
                             1, nfft)
            for s in range(n_seg)])
        ea = np.array([
            np.sum(np.abs(tmpl[s * span:(s + 1) * span]) ** 2)
            for s in range(n_seg)], np.float32)
        hit = (Gs, ea)
        _XC_FREQ_CACHE[key] = hit
    return hit


def _detect_metric_xcorr(sync: OfdmSync, ext: jnp.ndarray) -> jnp.ndarray:
    """Segmented-coherent S0 cross-correlation metric ``[n_metric]``.

    The known ``NUM_S0 x M`` S0 preamble is correlated coherently within
    ``_XC_SEG``-sample segments and |.|^2-combined across segments
    (normalized per segment by Cauchy-Schwarz to [0, 1]) — the same
    construction as the GMSK detector.  CFO-tolerant to ~pi/_XC_SEG
    rad/sample; holds ~2-3 dB below the Schmidl-Cox autocorrelation
    metric, whose lag-product SNR degrades quadratically (measured:
    v27-soft OFDM detection fell from 40/40 at 4 dB to 11/40 at 2 dB
    while every decoded header was clean).  S0 is period-M/4 periodic,
    so secondary peaks appear at +-M/4 offsets; NMS (radius M) keeps the
    strongest and the S1 fine-timing search window absorbs the residual
    offset like it absorbs the autocorrelation metric's CP plateau.
    """
    M = sync.params.M
    win = M
    n_metric = sync.block_size + 2 * win + 1
    L = ext.shape[0]
    span = _xc_span(NUM_S0 * M)
    n_seg = NUM_S0 * M // span
    from ..ops.corr import next_pow2
    nfft = next_pow2(L + NUM_S0 * M)
    Gs, ea = _xcorr_freq(sync.params, nfft)
    F = jnp.fft.fft(ext, nfft)
    pw = jnp.abs(ext) ** 2
    e24 = _moving_sum(jnp.concatenate(
        [pw, jnp.zeros((NUM_S0 * M,), pw.dtype)]), span)
    # equal-weight mean of per-segment normalized correlations, over the
    # FIXED segment count — NOT sum|u|^2 / sum(E ea): S0 is period-M/4
    # periodic, so at a k*span-early offset the lit segments correlate
    # perfectly while the silent ones contribute ~0 to both numerator
    # and energy, scoring 1.0 and creating exact-tie duplicate peaks
    # (found by test_single_frame_clean).  Per-segment normalization
    # caps a partial overlap at lit/n_seg; silent segments are zeroed by
    # the per-segment energy gate, which doubles as the silence gate.
    seg_floor = 1e-4 * span * (jnp.mean(pw) + 1e-12)
    # NOTE: a batched [n_seg, nfft] inverse FFT measured 2.3x SLOWER than
    # this sequential loop on the host backend (21 vs 9 ms/131k block) —
    # XLA:CPU threads within one large FFT but not across the batch.
    # Not measured on the GPU.
    acc = jnp.zeros((n_metric,), jnp.float32)
    for s in range(n_seg):
        off = s * span + span - 1
        u = jnp.fft.ifft(F * jnp.asarray(Gs[s]))[off:off + n_metric]
        Es = jax.lax.dynamic_slice_in_dim(e24, s * span, n_metric)
        r = (jnp.real(u) ** 2 + jnp.imag(u) ** 2) / \
            jnp.maximum(Es * float(ea[s]), 1e-12)
        acc = acc + jnp.where(Es > seg_floor, r, 0.0)
    return acc / n_seg


def topk_peaks(score: jnp.ndarray, k: int, min_dist: int):
    """Top-k of an NMS-suppressed score via a two-stage segmented reduce.

    After non-max suppression surviving peaks are >= ``min_dist`` apart, so
    segments shorter than ``min_dist`` hold at most one candidate each: a
    per-segment max + one top_k over segment maxima replaces the full-array
    sort (64x smaller on 131k blocks, where top_k is a major share of the
    per-block fixed cost).  Exactly equivalent to ``lax.top_k(score, k)``
    up to ordering of equal scores.
    """
    seg = min(64, min_dist)
    n = score.shape[0]
    n_seg = -(-n // seg)
    padded = jnp.concatenate(
        [score, jnp.full((n_seg * seg - n,), -1.0, score.dtype)])
    s2 = padded.reshape(n_seg, seg)
    seg_max = jnp.max(s2, axis=-1)
    seg_arg = jnp.argmax(s2, axis=-1)
    vals, seg_idx = jax.lax.top_k(seg_max, k)
    locs = seg_idx * seg + seg_arg[seg_idx]
    return vals, locs.astype(jnp.int32)


def _detect_candidates(sync: OfdmSync, ext: jnp.ndarray):
    """``(detected, locs, c_at)`` for one extended window."""
    if sync.xcorr_detect:
        # detect on the segmented-coherent S0 cross-correlation; the
        # lag-product correlation `c` (whose angle is the coarse CFO
        # estimate) is computed ONLY at the chosen candidate offsets —
        # a [K, L] gather instead of the full-stream cumsum metric
        # (which cost ~2.6 ms/131k block on the host just to be sampled
        # at <= K points)
        metric = _detect_metric_xcorr(sync, ext)
        detected, locs = _find_candidates(sync, metric)
        return detected, locs, _c_at(sync, ext, locs)
    metric, c = _detect_metric(sync, ext)
    detected, locs = _find_candidates(sync, metric)
    return detected, locs, c[jnp.clip(locs, 0, c.shape[0] - 1)]


def _c_at(sync: OfdmSync, ext: jnp.ndarray, locs: jnp.ndarray):
    """Lag-M/4 windowed correlation (the coarse-CFO phase reference) at
    the candidate offsets only: ``c[n] = sum_i ext[n+i] conj(ext[n+i+d])``
    over the S0 span — identical to sampling the full `_detect_metric`
    correlation at ``locs``."""
    M = sync.params.M
    d = M // 4
    L = NUM_S0 * M - d
    idx = locs[:, None] + jnp.arange(L)[None, :]
    idx = jnp.clip(idx, 0, ext.shape[0] - 1 - d)
    return jnp.sum(ext[idx] * jnp.conj(ext[idx + d]), axis=-1)


def _find_candidates(sync: OfdmSync, metric: jnp.ndarray):
    """Non-max-suppressed top-k candidate offsets.

    The detect region is ``[win, block_size + win)`` — inset by one NMS
    radius so every candidate has full suppression context on both sides
    (a region starting at offset 0 would let the falling edge of a peak
    owned by the *previous* block slip through as a duplicate).  The
    region tiling across blocks stays exact, just shifted by a constant.
    """
    M = sync.params.M
    T = sync.block_size
    win = M  # suppression radius ~ one symbol
    from ..ops.corr import sliding_max
    local_max = sliding_max(metric, win)
    is_peak = (metric >= local_max) & (metric > sync.threshold)
    idx = jnp.arange(metric.shape[0])
    in_region = (idx >= win) & (idx < T + win)
    score = jnp.where(is_peak & in_region, metric, -1.0)
    vals, locs = topk_peaks(score, sync.max_frames, 2 * win + 1)
    detected = vals > 0
    return detected, locs


# ---------------------------------------------------------------------------
# per-candidate decode
# ---------------------------------------------------------------------------

def _window_gather(ext: jnp.ndarray, start: jnp.ndarray, length: int):
    """Contiguous window ``ext[start : start+length]`` (traced start).

    A ``dynamic_slice``, not the index-array gather ``ext[start +
    arange]``: under the candidate vmap the slice moves only the
    W-sample window per candidate, while a traced index array becomes a
    general gather with an index tensor as large as the windows.  Edge
    semantics: a start past ``len-length`` clamps (window shifts left)
    instead of repeating the last sample — both only occur for candidates
    whose frame cannot fully decode from this block anyway (re-detected
    next block via the overlap), and every equality test runs both paths
    through this same primitive."""
    return jax.lax.dynamic_slice(ext, (start,), (length,))


def _equalized_symbols(sync: OfdmSync, w: jnp.ndarray, body_start: jnp.ndarray,
                       H: jnp.ndarray, n_sym: int, first_abs_sym: int,
                       n_valid_sym=None):
    """Demodulate ``n_sym`` OFDM symbols from derotated window ``w``.

    Returns equalized data-carrier values ``[n_sym, n_data]`` after pilot
    common-phase and timing-slope correction.  ``n_valid_sym`` (traced)
    marks how many leading symbols belong to THIS frame — the static
    max-budget window may extend into the next burst, whose full-strength
    pilots must not feed this frame's phase-trend fit.
    """
    p = sync.params
    M, cp = p.M, p.cp_len
    n_data = len(p.data_idx)
    # symbol grid as ONE contiguous dynamic_slice + reshape: symbol k
    # occupies [body+cp + k*(M+cp), +M), i.e. the first M columns of the
    # [n_sym, M+cp] reshape of a single span, not an index-array gather
    # (see _window_gather).  Zero-pad so any in-window body_start slices
    # without clamping (beyond-window spans read zeros instead of the old
    # repeated-last-sample; both only happen for undecodable frames).
    span = n_sym * (M + cp)
    wpad = jnp.pad(w, (0, span + cp))
    seg = jax.lax.dynamic_slice(wpad, (body_start + cp,), (span,))
    time_syms = seg.reshape(n_sym, M + cp)[:, :M]        # [n_sym, M]
    Y = jnp.fft.fft(time_syms, axis=-1).astype(jnp.complex64) / \
        jnp.sqrt(jnp.float32(M))
    Hsafe = jnp.where(jnp.abs(H) > 1e-6, H, 1.0)
    Yeq = Y / Hsafe[None, :]
    # pilot correction
    pil_idx = jnp.asarray(p.pilot_idx)
    sym_abs = first_abs_sym + jnp.arange(n_sym)
    pref = _pilot_values(p, sym_abs).astype(jnp.complex64)  # [n_sym, n_pilot]
    rot = Yeq[:, pil_idx] * jnp.conj(pref)               # ~ e^{j err}
    # common phase: the per-symbol estimate from ~6 pilots is noise
    # limited (std ~ 1/sqrt(n_pilot*SNR)); the true CPE trend is linear in
    # the symbol index (residual CFO), so fit a weighted line over the
    # unwrapped per-symbol phases — ~sqrt(n_sym) lower phase noise
    rsum = jnp.sum(rot, axis=-1)
    cpe_raw = jnp.angle(rsum)                            # [n_sym]
    dphi = jnp.mod(jnp.diff(cpe_raw) + np.pi, 2 * np.pi) - np.pi
    cpe_u = jnp.concatenate([cpe_raw[:1],
                             cpe_raw[0] + jnp.cumsum(dphi)])
    wgt_s = jnp.abs(rsum)
    t_i = jnp.arange(n_sym, dtype=jnp.float32)
    if n_valid_sym is not None:
        # hard-gate symbols beyond this frame out of the fit: the window
        # tail may hold the NEXT burst's pilots (full strength, different
        # phase reference) or clipped garbage
        wgt_s = jnp.where(t_i < n_valid_sym, wgt_s, 0.0)
    wgt_s = wgt_s + 1e-9
    tbar = jnp.sum(wgt_s * t_i) / jnp.sum(wgt_s)
    cbar = jnp.sum(wgt_s * cpe_u) / jnp.sum(wgt_s)
    bnum = jnp.sum(wgt_s * (t_i - tbar) * (cpe_u - cbar))
    bden = jnp.maximum(jnp.sum(wgt_s * (t_i - tbar) ** 2), 1e-6)
    cpe = cbar + (bnum / bden) * (t_i - tbar)            # [n_sym]
    # timing slope across frequency (pilot freq positions, centered)
    f = jnp.asarray(np.where(p.pilot_idx > p.M // 2,
                             p.pilot_idx - p.M, p.pilot_idx),
                    dtype=jnp.float32)
    th = jnp.angle(rot * jnp.exp(-1j * cpe)[:, None])    # residual per pilot
    wgt = jnp.abs(rot)
    # GLOBAL timing slope: the frequency-linear phase term is a sampling
    # offset — constant over the frame — so pool every valid symbol's
    # pilots into one weighted fit (~sqrt(n_sym) lower slope noise than
    # the per-symbol estimate; same flat fidelity story as the flex
    # pilot-trend rebuild).  wgt_s (the frame-validity gate) zeroes
    # foreign symbols out of the pool.
    wpool = wgt * (wgt_s[:, None] > 1e-8)
    denom = jnp.maximum(jnp.sum(wpool * f * f), 1e-6)
    slope_g = jnp.sum(wpool * th * f) / denom
    slope = jnp.broadcast_to(slope_g, cpe.shape)         # [n_sym]
    data_idx = jnp.asarray(p.data_idx)
    fd = jnp.asarray(np.where(p.data_idx > p.M // 2,
                              p.data_idx - p.M, p.data_idx),
                     dtype=jnp.float32)
    corr = jnp.exp(-1j * (cpe[:, None] + slope[:, None] * fd[None, :]))
    return Yeq[:, data_idx] * corr


def _decode_candidate(sync: OfdmSync, ext: jnp.ndarray, n0: jnp.ndarray,
                      c_at: jnp.ndarray, debug: bool = False):
    """Full refine+decode for one candidate offset ``n0`` (vmapped).

    ``debug=True`` (trace-time flag; never used on the hot path) appends
    a dict of synchronizer internals — channel estimate, equalized
    header/payload constellation points — for :func:`debug_capture`."""
    wraw = _window_gather(ext, n0, sync.overlap)
    return _decode_window(sync, wraw, c_at, debug)


def _decode_window(sync: OfdmSync, wraw: jnp.ndarray, c_at: jnp.ndarray,
                   debug: bool = False):
    """Refine+decode one already-sliced max-frame window ``wraw [W]``."""
    p = sync.params
    M, cp = p.M, p.cp_len
    n_hsym = header_symbol_count(p)
    W = sync.overlap  # window covers a max frame from n0

    cfo = -jnp.angle(c_at) / (M // 4)
    t = jnp.arange(W, dtype=jnp.float32)
    # fine CFO: the two S0 symbols repeat with period M, giving 4x the
    # discriminator lag of the coarse lag-M/4 estimate (Schmidl-Cox-style
    # second stage); the coarse residual is well inside the +-pi/M
    # unambiguous range, so the composition is unconditionally valid.
    # The coarse derotation cancels inside the lag product up to the
    # constant e^{+j cfo M}, so no intermediate derotated window is
    # materialized (one fewer full-window rotate per candidate).
    c_fine = jnp.sum(wraw[:M] * jnp.conj(wraw[M:2 * M])) * \
        jnp.exp(1j * cfo * M)
    cfo = cfo - jnp.angle(c_fine) / M
    w = wraw * jnp.exp(-1j * cfo * t)

    # fine timing: S1 matched filter over [0, (NUM_S0+2)*M)
    search = (NUM_S0 + 2) * M
    s1 = jnp.conj(jnp.asarray(p.s1_time))
    seg = w[:search + M]
    idx = jnp.arange(search)[:, None] + jnp.arange(M)[None, :]
    wins = seg[idx]                                       # [search, M]
    # HIGHEST: TF32 would blur the S1 peak against its CP-shifted
    # neighbours, and the argmax below picks the frame timing
    corr = jnp.matmul(wins, s1, precision=jax.lax.Precision.HIGHEST)
    energy = jnp.sqrt(jnp.maximum(
        jnp.sum(jnp.abs(wins) ** 2, axis=-1), 1e-12))
    t1 = jnp.argmax(jnp.abs(corr) / energy).astype(jnp.int32)

    # channel estimate from S1
    r1 = jax.lax.dynamic_slice(w, (t1,), (M,))
    R1 = jnp.fft.fft(r1) / jnp.sqrt(jnp.float32(M))
    s1f = jnp.asarray(p.s1_freq)
    active = jnp.abs(s1f) > 1e-6
    H = jnp.where(active, R1 * jnp.conj(s1f) /
                  jnp.maximum(jnp.abs(s1f) ** 2, 1e-12), 1.0)
    # S0-augmented estimate: the two S0 symbols precede S1 (periodic,
    # no CP) and carry known values on every 4th carrier — two extra
    # observations there, obs-count-weighted into the S1 LS estimate
    # (same FFT-window timing offset t1, so the per-carrier phase slopes
    # are consistent).  Gated on t1 >= 2M so a degenerate fine-timing
    # pick cannot pull noise ahead of the frame into H.
    r0 = jax.lax.dynamic_slice(
        w, (jnp.maximum(t1 - 2 * M, 0),), (2 * M,))
    R0 = (jnp.fft.fft(r0[:M]) + jnp.fft.fft(r0[M:])) / \
        (2.0 * jnp.sqrt(jnp.float32(M)))
    s0f = jnp.asarray(p.s0_freq)
    act0 = (jnp.abs(s0f) > 1e-6) & (t1 >= 2 * M)
    H0 = R0 * jnp.conj(s0f) / jnp.maximum(jnp.abs(s0f) ** 2, 1e-12)
    H = jnp.where(act0, (H + 2.0 * H0) / 3.0, H)
    # smooth the LS estimate across physically-adjacent active carriers:
    # a single-symbol LS estimate costs ~3 dB of EQ noise; a [1 2 1]/4
    # kernel over the frequency-sorted active set recovers most of it
    # (channel coherence across 3 carriers holds for the delay spreads the
    # framework models)
    order = np.argsort([k - M if k > M // 2 else k
                        for k in sorted(set(p.data_idx.tolist()) |
                                        set(p.pilot_idx.tolist()))])
    act_sorted = np.array(sorted(set(p.data_idx.tolist()) |
                                 set(p.pilot_idx.tolist())))[order]
    Ha = H[jnp.asarray(act_sorted)]
    Hpad = jnp.concatenate([Ha[:1], Ha, Ha[-1:]])
    Hs = 0.25 * Hpad[:-2] + 0.5 * Hpad[1:-1] + 0.25 * Hpad[2:]
    H = H.at[jnp.asarray(act_sorted)].set(Hs)

    body = t1 + M
    # header symbols
    hdata = _equalized_symbols(sync, w, body, H, n_hsym, 0)
    hflat = hdata.reshape(-1)[:HEADER_SYMS]
    hsym = modem_mod.demodulate(_HEADER_MOD, hflat)
    if sync.soft:
        # soft header: exact-ML Golay from channel LLRs (~2 dB of header
        # sensitivity — the waterfall once the payload FEC is strong)
        hllrs = payload_codec.generic_demod_soft(
            hflat, jnp.int32(_HEADER_MOD),
            payload_codec.HEADER_ENC_BYTES * 8)
        (user, plen, mod, f0, f1, check,
         hvalid) = payload_codec.decode_header_soft(
            hllrs, sync.max_payload, len(sync.fecs))
    else:
        hbits = modem_mod.symbols_to_bits(hsym, _HEADER_BPS)
        hbytes = payload_codec.header_bits_to_bytes(hbits)
        (user, plen, mod, f0, f1, check,
         hvalid) = payload_codec.decode_header(
            hbytes, sync.max_payload, len(sync.fecs))

    # header EVM (uses decided symbols as reference)
    hevm = modem_mod.evm(_HEADER_MOD, hflat, hsym)

    # decision-directed channel refinement: the header's BPSK decisions
    # give n_hsym extra observations per data carrier on top of the single
    # S1 symbol, shrinking the EQ-noise penalty before payload demod
    n_data = len(p.data_idx)
    dec_pts = modem_mod.modulate(_HEADER_MOD, hsym)
    pad = n_hsym * n_data - HEADER_SYMS
    dec_grid = jnp.concatenate(
        [dec_pts, jnp.zeros((pad,), dec_pts.dtype)]).reshape(n_hsym, n_data)
    used = jnp.concatenate(
        [jnp.ones((HEADER_SYMS,), jnp.float32),
         jnp.zeros((pad,), jnp.float32)]).reshape(n_hsym, n_data)
    r = jnp.sum(hdata * jnp.conj(dec_grid) * used, axis=0) / \
        jnp.maximum(jnp.sum(used, axis=0), 1.0)
    # blend with the unit prior (S1 estimate) in proportion to the number
    # of header observations per carrier, and guard degenerate magnitudes
    nobs = jnp.sum(used, axis=0)
    r = (nobs * r + 1.0) / (nobs + 1.0)
    r = jnp.where(jnp.abs(r) > 0.2, r, 1.0)

    # second header-decode iteration: re-decode on the DD-refined channel
    # (r cuts the per-carrier EQ noise ~1/n_obs); fields merge only when
    # pass 1 failed, so a valid pass-1 header is never perturbed.  At the
    # 0-1 dB waterfall the header is EQ-noise-limited —
    # this recovers marginal Golay blocks for one extra decode per
    # candidate.
    if sync.iter_header:
        hflat2 = (hdata / r[None, :]).reshape(-1)[:HEADER_SYMS]
        if sync.soft:
            hllrs2 = payload_codec.generic_demod_soft(
                hflat2, jnp.int32(_HEADER_MOD),
                payload_codec.HEADER_ENC_BYTES * 8)
            (user2, plen2, mod2, f02, f12, check2,
             hvalid2) = payload_codec.decode_header_soft(
                hllrs2, sync.max_payload, len(sync.fecs))
        else:
            hsym2 = modem_mod.demodulate(_HEADER_MOD, hflat2)
            hbits2 = modem_mod.symbols_to_bits(hsym2, _HEADER_BPS)
            hbytes2 = payload_codec.header_bits_to_bytes(hbits2)
            (user2, plen2, mod2, f02, f12, check2,
             hvalid2) = payload_codec.decode_header(
                hbytes2, sync.max_payload, len(sync.fecs))
        take = (~hvalid) & hvalid2
        user = jnp.where(take, user2, user)
        plen = jnp.where(take, plen2, plen)
        mod = jnp.where(take, mod2, mod)
        f0 = jnp.where(take, f02, f0)
        f1 = jnp.where(take, f12, f1)
        check = jnp.where(take, check2, check)
        hvalid = hvalid | hvalid2

    # payload constellation points (FEC decode happens batched outside
    # the candidate vmap — see decode_payload_batch); the phase-trend fit
    # must only see THIS frame's symbols, whose count follows from the
    # decoded header
    used_pts = payload_codec.payload_points_used(
        sync.fecs, sync.dec_max, sync.enc_max, plen, mod, f0, f1, check)
    n_valid = jnp.clip(-(-used_pts // n_data), 1, sync.max_psym)
    pdata = _equalized_symbols(
        sync, w, body + n_hsym * (M + cp), H, sync.max_psym, n_hsym,
        n_valid_sym=jnp.where(hvalid, n_valid, sync.max_psym))
    pdata = pdata / r[None, :]

    # payload decision-directed re-estimation (second pass): first-pass
    # decisions over up to _DD_SYMS payload symbols add far more
    # per-carrier observations than S1 + header alone (the remaining
    # EQ-noise penalty shrinks ~1/n_obs).  Decisions use the
    # header-advertised scheme via the shared stacked tables (padded
    # entries sit at 1e6 so argmin never picks them); observations are
    # weighted by decision energy (zero-energy points — OOK off — carry
    # no information) and masked to THIS frame's points; the whole
    # correction is gated on header validity.
    if sync.max_psym > 0:
        dd_syms = min(_DD_SYMS, sync.max_psym)
        tab = jnp.asarray(payload_codec._stacked_tables())[mod]
        sub = pdata[:dd_syms]                            # [dd, n_data]
        # nearest POINT carried by value — a tab[sym] traced gather here
        # was 65% of the whole refine stage on chip (refine_probe dd_tab)
        dec, _ = payload_codec._nearest_point(sub.reshape(-1), tab)
        dec = dec.reshape(sub.shape)                     # [dd, n_data]
        pt_i = (jnp.arange(dd_syms)[:, None] * n_data +
                jnp.arange(n_data)[None, :])
        wgt = ((pt_i < used_pts) & hvalid).astype(jnp.float32) * \
            jnp.abs(dec) ** 2
        num = jnp.sum(sub * jnp.conj(dec) * wgt, axis=0)
        den = jnp.sum(jnp.abs(dec) ** 2 * wgt, axis=0)
        # blend with the unit prior in proportion to the observation
        # mass so sparse carriers stay put
        r2 = (num + 1.0) / (den + 1.0)
        r2 = jnp.where(jnp.abs(r2) > 0.2, r2, 1.0)
        pdata = pdata / r2[None, :]

    # stats (wraw starts at n0 and |wraw| == |ext| over the preamble, so
    # the already-gathered window serves as the RSSI span)
    rssi = 10.0 * jnp.log10(jnp.maximum(
        jnp.mean(jnp.abs(wraw[:NUM_S0 * M]) ** 2), 1e-12))
    out = (user, pdata.reshape(-1), plen, mod, f0, f1, check, hvalid,
           rssi, hevm, cfo)
    if debug:
        return out + ({"H": H, "t1": t1, "hsyms_eq": hflat,
                       "used_pts": used_pts},)
    return out


# ---------------------------------------------------------------------------
# top-level block step
# ---------------------------------------------------------------------------

def _gated_decode(sync: OfdmSync, source: jnp.ndarray, gate, locs, c_at,
                  row_of: jnp.ndarray | None = None):
    """``lax.cond``-gated batched candidate decode against ``source``.

    RX streams are mostly idle noise, so the expensive refine/EQ/FEC graph
    only runs when anything was detected.  ``locs``/``c_at`` are flat
    ``[R]`` offsets into ``source``; with ``row_of`` the source carries a
    leading rows axis and candidate ``r`` reads window ``locs[r]`` of row
    ``row_of[r]`` — as ONE fused 2D dynamic_slice per candidate, so only
    the W-sample window ever moves (the repeated-rows array this replaces
    cost R*len(row) of HBM).  Returns the 12-tuple of per-candidate
    results (zeros when gated off).
    """
    R = locs.shape[0]
    W = sync.overlap

    def do_decode(args):
        locs_, c_at_ = args
        if row_of is None:
            win = jax.vmap(
                lambda n0: _window_gather(source, n0, W))(locs_)
        else:
            win = jax.vmap(
                lambda r, n0: jax.lax.dynamic_slice(
                    source, (r, n0), (1, W))[0])(row_of, locs_)
        (user, points, plen, mod, f0, f1, check, hvalid, rssi, hevm,
         cfo) = jax.vmap(
            lambda w, ca: _decode_window(sync, w, ca))(win, c_at_)
        decode_fn = (payload_codec.decode_payload_batch_soft if sync.soft
                     else payload_codec.decode_payload_batch)
        payload, pvalid = decode_fn(
            sync.enc_max, sync.dec_max, sync.max_payload,
            points, mod, f0, f1, check, plen, hvalid, sync.fecs)
        # frame EVM = header + payload symbols (framesyncstats parity)
        used = payload_codec.payload_points_used(
            sync.fecs, sync.dec_max, sync.enc_max, plen, mod, f0, f1,
            check)
        evm = payload_codec.frame_evm_db(
            hevm, payload_codec.payload_evm_mse(points, mod, used), used)
        evm = jnp.where(hvalid, evm, hevm)
        return (user, payload, plen, mod, f0, f1, check, hvalid, pvalid,
                rssi, evm, cfo)

    def skip_decode(args):
        f32 = jnp.float32
        return (jnp.zeros((R, 8), jnp.uint8),
                jnp.zeros((R, sync.max_payload), jnp.uint8),
                jnp.zeros((R,), jnp.int32), jnp.zeros((R,), jnp.int32),
                jnp.zeros((R,), jnp.int32), jnp.zeros((R,), jnp.int32),
                jnp.zeros((R,), jnp.int32), jnp.zeros((R,), bool),
                jnp.zeros((R,), bool), jnp.zeros((R,), f32),
                jnp.zeros((R,), f32), jnp.zeros((R,), f32))

    return jax.lax.cond(gate, do_decode, skip_decode, (locs, c_at))


def sync_block(sync: OfdmSync, state: OfdmSyncState, block: jnp.ndarray):
    """Process one block of ``block_size`` samples.

    Returns ``(state', FrameResults)``; results are fixed-shape with
    ``detected`` masks.  For a jitted closure over a fixed config use
    :func:`make_sync_step`.
    """
    block = iqfmt.iq_from_any(block)      # accepts [2, bs] bf16 planes
    assert block.shape[-1] == sync.block_size
    ext = jnp.concatenate([state.tail, block])
    detected, locs, c_at = _detect_candidates(sync, ext)

    (user, payload, plen, mod, f0, f1, check, hvalid, pvalid, rssi, evm,
     cfo) = _gated_decode(sync, ext, jnp.any(detected), locs, c_at)

    res = FrameResults(
        detected=detected,
        header_valid=detected & hvalid,
        payload_valid=detected & pvalid,
        header=user, payload=payload,
        payload_len=jnp.where(detected, plen, 0),
        mod=mod, fec0=f0, fec1=f1, check=check,
        rssi=rssi, evm=evm, cfo=cfo,
        t_start=state.base + locs.astype(jnp.int32),
    )
    new_state = OfdmSyncState(
        tail=ext[ext.shape[0] - sync.overlap:],
        base=state.base + sync.block_size)
    return new_state, res


def make_sync_step(sync: OfdmSync):
    """Jitted ``step(state, block) -> (state', FrameResults)`` closure.

    The config (incl. its NumPy tables) is captured as compile-time
    constants, which is the functional analog of the reference's
    per-instance synchronizer object.
    """
    @jax.jit
    def step(state, block):
        return sync_block(sync, state, block)
    return step


def debug_capture(sync: OfdmSync, stream) -> dict:
    """One-shot synchronizer-internals capture for the strongest
    candidate in ``stream`` — the debug-parity surface of the reference's
    framesync debug dump, which records received constellation points and
    synchronizer state (/root/reference/lib/ofdmtxrx.cc:518-525).

    Returns a dict of NumPy arrays: ``metric`` (the detector the sync
    actually runs), ``detected``, ``n0``, ``cfo``, ``rssi``,
    ``header_valid``, ``H`` (the smoothed channel estimate ``[M]`` used
    for equalization), ``hsyms_eq`` (equalized header constellation
    points), ``psyms_eq`` (equalized payload constellation points of this
    frame).  Eager and one-shot — never on the hot path.
    """
    import numpy as _np
    ext = iqfmt.iq_from_any(jnp.asarray(stream))
    need = sync.block_size + sync.overlap
    if ext.shape[0] < need:
        ext = jnp.concatenate(
            [ext, jnp.zeros(need - ext.shape[0], ext.dtype)])
    ext = ext[:need]
    detected, locs, c_at = _detect_candidates(sync, ext)
    if sync.xcorr_detect:
        metric = _detect_metric_xcorr(sync, ext)
    else:
        metric, _ = _detect_metric(sync, ext)
    best = int(_np.argmax(_np.where(_np.asarray(detected),
                                    _np.asarray(metric)[_np.asarray(locs)],
                                    -1.0)))
    (user, points, plen, mod, f0, f1, check, hvalid, rssi, hevm, cfo,
     dbg) = _decode_candidate(sync, ext, locs[best], c_at[best],
                              debug=True)
    used = int(_np.asarray(dbg["used_pts"]))
    return {
        "metric": _np.asarray(metric),
        "detected": bool(_np.asarray(detected)[best]),
        "n0": int(_np.asarray(locs)[best]),
        "cfo": float(_np.asarray(cfo)),
        "rssi": float(_np.asarray(rssi)),
        "header_valid": bool(_np.asarray(hvalid)),
        "H": _np.asarray(dbg["H"]),
        "hsyms_eq": _np.asarray(dbg["hsyms_eq"]),
        "psyms_eq": _np.asarray(points)[:max(used, 1)],
    }


def sync_blocks_batched(sync: OfdmSync, state: OfdmSyncState,
                        blocks: jnp.ndarray):
    """Multi-block batched dispatch: ``blocks [n_blocks, block_size]`` ->
    ``(state', FrameResults with leading [n_blocks, max_frames])``.

    The detect front-end has no true sequential dependence — each block's
    extended window is just a strided slice of ``tail ++ blocks`` — so the
    ``lax.scan`` of repeated :func:`sync_block` calls is replaced by a
    ``vmap`` over the block axis (bit-identical per-ext computation), and
    the candidates of ALL blocks decode in one flat batch against the full
    stream buffer.  One device dispatch per multi-block chunk amortizes the
    per-block fixed cost that dominates at small block sizes.
    """
    blocks = iqfmt.iq_from_any(blocks)    # accepts [2, n_blocks, bs] planes
    n_blocks, bs = blocks.shape
    assert bs == sync.block_size
    K = sync.max_frames
    full = jnp.concatenate([state.tail, blocks.reshape(-1)])
    # per-block extended windows (same arrays the sequential path sees);
    # static slices, never an index-array gather (see _window_gather)
    exts = jnp.stack([
        jax.lax.slice_in_dim(full, i * bs, i * bs + sync.overlap + bs)
        for i in range(n_blocks)])                  # [n_blocks, overlap+bs]

    detected, locs, c_at = jax.vmap(
        lambda e: _detect_candidates(sync, e))(exts)  # [n_blocks, K]

    # decode each candidate against its OWN block's extended window (the
    # exact array the sequential path sees), so results — including any
    # estimator that touches the beyond-frame garbage tail — stay
    # bit-identical to scan-of-sync_block
    blk_of = jnp.repeat(jnp.arange(n_blocks), K)
    (user, payload, plen, mod, f0, f1, check, hvalid, pvalid, rssi, evm,
     cfo) = _gated_decode(sync, exts, jnp.any(detected),
                          locs.reshape(-1), c_at.reshape(-1),
                          row_of=blk_of)

    def rs(v):
        return v.reshape((n_blocks, K) + v.shape[1:])

    res = FrameResults(
        detected=detected,
        header_valid=detected & rs(hvalid),
        payload_valid=detected & rs(pvalid),
        header=rs(user), payload=rs(payload),
        payload_len=jnp.where(detected, rs(plen), 0),
        mod=rs(mod), fec0=rs(f0), fec1=rs(f1), check=rs(check),
        rssi=rs(rssi), evm=rs(evm), cfo=rs(cfo),
        t_start=(state.base + jnp.arange(n_blocks, dtype=jnp.int32)[:, None]
                 * bs + locs.astype(jnp.int32)),
    )
    new_state = OfdmSyncState(
        tail=full[full.shape[0] - sync.overlap:],
        base=state.base + jnp.int32(n_blocks * bs))
    return new_state, res


def sync_channels_batched(sync: OfdmSync, states: OfdmSyncState,
                          chans: jnp.ndarray):
    """Channel-and-block batched dispatch for N independent streams.

    ``states``: stacked per-channel :class:`OfdmSyncState` (leading [N]);
    ``chans [N, n_blocks, block_size]`` -> ``(states', FrameResults with
    leading [N, n_blocks, max_frames])``.

    The detect front-end vmaps over all N*n_blocks extended windows and
    the candidates of EVERY channel decode in one flat batch behind a
    single global gate.  This replaces ``vmap(sync_block)`` over the
    channel axis, where the per-channel ``lax.cond`` decode gate lowers
    to a select that always runs the decode — and the nested
    channel-over-candidate vmap lowers the per-candidate gathers badly:
    the measured idle-stream cost of the 4-channel vmapped step was
    ~300x the runtime-gated single-channel path (1.13 s vs 3.4 ms/32k
    block on the host).  Detected/valid-masked fields are identical to
    the per-channel path; undetected rows differ in the unmasked fields
    exactly as in :func:`sync_blocks_batched`.
    """
    chans = iqfmt.iq_from_any(chans)  # accepts [2, N, nb, bs] planes
    N, n_blocks, bs = chans.shape
    assert bs == sync.block_size
    K = sync.max_frames
    full = jnp.concatenate([states.tail, chans.reshape(N, -1)], axis=-1)
    # static slices, never an index-array gather (see _window_gather)
    exts = jnp.stack([
        jax.lax.slice_in_dim(full, i * bs, i * bs + sync.overlap + bs,
                             axis=1)
        for i in range(n_blocks)], axis=1).reshape(
        N * n_blocks, sync.overlap + bs)

    detected, locs, c_at = jax.vmap(
        lambda e: _detect_candidates(sync, e))(exts)  # [N*nb, K]

    row_of = jnp.repeat(jnp.arange(N * n_blocks), K)
    (user, payload, plen, mod, f0, f1, check, hvalid, pvalid, rssi, evm,
     cfo) = _gated_decode(sync, exts, jnp.any(detected),
                          locs.reshape(-1), c_at.reshape(-1),
                          row_of=row_of)

    def rs(v):
        return v.reshape((N, n_blocks, K) + v.shape[1:])

    detected = detected.reshape(N, n_blocks, K)
    locs = locs.reshape(N, n_blocks, K)
    res = FrameResults(
        detected=detected,
        header_valid=detected & rs(hvalid),
        payload_valid=detected & rs(pvalid),
        header=rs(user), payload=rs(payload),
        payload_len=jnp.where(detected, rs(plen), 0),
        mod=rs(mod), fec0=rs(f0), fec1=rs(f1), check=rs(check),
        rssi=rs(rssi), evm=rs(evm), cfo=rs(cfo),
        t_start=(states.base[:, None, None] +
                 jnp.arange(n_blocks, dtype=jnp.int32)[None, :, None] * bs +
                 locs.astype(jnp.int32)),
    )
    new_states = OfdmSyncState(
        tail=full[:, full.shape[-1] - sync.overlap:],
        base=states.base + jnp.int32(n_blocks * bs))
    return new_states, res
