"""Single-carrier flexframe synchronizer (RX) — batched block dataflow.

Capability parity: ``flexframesync`` / ``framesync64`` — burst detection,
CFO + gain/phase estimation, matched-filter symbol recovery with fractional
timing, header decode -> per-packet payload props, payload decode with CRC
gate (/root/reference/src/flexframe_rx.cc:190-243, src/packet_rx.cc:190).

Same block architecture as the OFDM sync (overlap region, detect ->
``vmap`` candidates -> shared payload codec):

1. matched-filter the whole extended block (one streaming FIR),
2. preamble cross-correlation at symbol stride for every offset (a strided
   window gather + matvec against the known PN preamble), energy-normalized,
3. per candidate: CFO from split-preamble correlation phase, fractional
   timing by parabolic interpolation of the correlation peak, complex gain
   from the derotated preamble, linear-interpolated symbol sampling,
   per-pilot-segment phase tracking across the payload, then the shared
   header/payload codec.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import iqfmt
from ..ops import modem as modem_mod
from . import payload as payload_codec
from .phase_track import track_phase_bpsk
from .flexframe import (FLEX_HEADER_USER, FlexParams, PILOT_SPACING,
                        PREAMBLE_SYMS, slots_layout)
from .payload import EXPANSION as _EXPANSION, HEADER_BPS, HEADER_MOD

__all__ = ["FlexSync", "FlexSyncState", "make_flex_sync", "flex_sync_init",
           "flex_sync_block", "make_flex_sync_step",
           "flex_sync_blocks_batched"]


class FlexSync(NamedTuple):
    params: FlexParams
    block_size: int
    max_payload: int
    max_frames: int
    threshold: float
    overlap: int
    max_slots: int             # payload section slot budget
    dec_max: int
    enc_max: int
    fecs: tuple = payload_codec.PAYLOAD_FECS
    soft: bool = False
    header_user: int = FLEX_HEADER_USER   # user-header bytes (static)


class FlexSyncState(NamedTuple):
    tail: jnp.ndarray          # [overlap] complex64 raw samples
    base: jnp.ndarray          # int32 stream index; t_start timestamps
    # inherit its wrap at 2^31 samples (~3.6 min at 10 MS/s) — matching
    # the fixed-width counters of a long-running framesync


class FlexResults(NamedTuple):
    detected: jnp.ndarray
    header_valid: jnp.ndarray
    payload_valid: jnp.ndarray
    header: jnp.ndarray
    payload: jnp.ndarray
    payload_len: jnp.ndarray
    mod: jnp.ndarray
    fec0: jnp.ndarray
    fec1: jnp.ndarray
    check: jnp.ndarray
    rssi: jnp.ndarray
    evm: jnp.ndarray
    cfo: jnp.ndarray
    t_start: jnp.ndarray


def make_flex_sync(params: FlexParams, block_size: int = 16384,
                   max_payload: int = 2048, max_frames: int = 8,
                   threshold: float = 0.5, enable_conv: bool = False,
                   soft: bool = False,
                   expansion: int = _EXPANSION,
                   header_user: int = FLEX_HEADER_USER) -> FlexSync:
    if expansion < 1:
        raise ValueError(f"expansion must be >= 1 (got {expansion})")
    dec_max = max_payload + 4
    enc_max = expansion * dec_max   # see payload.check_budget
    # +1 point: DPSK payloads lead with a phase-reference point
    max_data = enc_max * 8 + 1                  # bps >= 1
    max_slots = max_data + -(-max_data // (PILOT_SPACING - 1))
    n_syms = PREAMBLE_SYMS + payload_codec.header_syms(header_user) \
        + max_slots
    max_frame = n_syms * params.k + 4 * params.m * params.k
    fecs = (payload_codec.PAYLOAD_FECS_FULL if enable_conv
            else payload_codec.PAYLOAD_FECS)
    # overlap margin beyond the frame: detect-region inset + matched-
    # filter group delay + fractional-delay interpolation reads.  The
    # old 8k margin only cleared the default k=2/m=7 geometry (by 4.5
    # samples); smaller m (shorter MF group delay shifts n0 later
    # relative to the symbol reads) ran up to ~50 samples past the
    # buffer and clipped payload tails at block seams.
    return FlexSync(params=params, block_size=block_size,
                    max_payload=max_payload, max_frames=max_frames,
                    threshold=threshold,
                    overlap=max_frame + 32 * params.k + 32,
                    max_slots=max_slots, dec_max=dec_max, enc_max=enc_max,
                    fecs=fecs, soft=soft, header_user=header_user)


def flex_sync_init(sync: FlexSync) -> FlexSyncState:
    return FlexSyncState(
        tail=jnp.zeros((sync.overlap,), jnp.complex64),
        base=jnp.int32(-sync.overlap))


_FD_NPFB = 64      # fractional-delay phases
_FD_SEMI = 4       # taps = 2*semi


@functools.lru_cache(maxsize=None)
def _fd_bank() -> np.ndarray:
    """Windowed-sinc fractional-delay bank ``[npfb+1, 8]``: row p delays
    by ``p/npfb`` samples (row npfb duplicates row 0 shifted, for lerp)."""
    t = np.arange(-_FD_SEMI, _FD_SEMI, dtype=np.float64)  # 8 taps
    rows = []
    for p in range(_FD_NPFB + 1):
        mu = p / _FD_NPFB
        h = np.sinc(t + 1 - mu) * np.kaiser(2 * _FD_SEMI, 7.0)
        rows.append(h / h.sum())
    return np.asarray(rows, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _fe_freq_np(k: int, m: int, beta: float, nfft: int):
    """Host-precomputed frequency responses for the front-end FFT chain:
    ``(H_mf, G1, G2)`` — RRC matched filter and the two k-dilated
    preamble-half correlators (see ops.corr.comb_rev_freq_np)."""
    from ..ops.corr import comb_rev_freq_np
    from .flexframe import make_flex_params
    p = make_flex_params(k, m, beta)
    half = PREAMBLE_SYMS // 2
    H = np.fft.fft(p.taps.astype(np.complex64), nfft).astype(np.complex64)
    G1 = comb_rev_freq_np(p.preamble[:half], k, nfft)
    G2 = comb_rev_freq_np(p.preamble[half:], k, nfft)
    return H, G1, G2


def _find_candidates(sync: FlexSync, metric: jnp.ndarray):
    # detect region inset by the NMS radius (full suppression context on
    # both sides; see ofdm_sync._find_candidates)
    T = sync.block_size
    win = sync.params.k * PREAMBLE_SYMS // 2
    from ..ops.corr import sliding_max
    local_max = sliding_max(metric, win)
    is_peak = (metric >= local_max) & (metric > sync.threshold)
    idx = jnp.arange(metric.shape[0])
    score = jnp.where(is_peak & (idx >= win) & (idx < T + win), metric,
                      -1.0)
    from .ofdm_sync import topk_peaks
    vals, locs = topk_peaks(score, sync.max_frames, 2 * win + 1)
    return vals > 0, locs


def _decode_candidate(sync: FlexSync, mf: jnp.ndarray, metric: jnp.ndarray,
                      n0: jnp.ndarray, c1: jnp.ndarray, c2: jnp.ndarray):
    p = sync.params
    k = p.k
    half = PREAMBLE_SYMS // 2

    # CFO from split preamble halves (phase advance over half*k samples)
    cfo = jnp.angle(c2 * jnp.conj(c1)) / (half * k)

    # fractional timing: parabolic fit on the metric around the peak
    m_m1 = metric[jnp.clip(n0 - 1, 0, metric.shape[0] - 1)]
    m_0 = metric[n0]
    m_p1 = metric[jnp.clip(n0 + 1, 0, metric.shape[0] - 1)]
    denom = m_m1 - 2 * m_0 + m_p1
    delta = jnp.where(jnp.abs(denom) > 1e-9,
                      0.5 * (m_m1 - m_p1) / denom, 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)

    # symbol sample positions: preamble starts at n0 (+delta fractional)
    hdr_syms = payload_codec.header_syms(sync.header_user)
    n_syms = PREAMBLE_SYMS + hdr_syms + sync.max_slots
    pos = n0.astype(jnp.float32) + delta + k * jnp.arange(
        n_syms, dtype=jnp.float32)
    i0 = jnp.floor(pos).astype(jnp.int32)
    frac = pos - i0.astype(jnp.float32)
    i0 = jnp.clip(i0, _FD_SEMI, mf.shape[0] - _FD_SEMI - 1)
    # polyphase fractional-delay sampling (windowed-sinc bank, lerped
    # between adjacent phases) — linear interpolation costs ~0.5-1 dB of
    # effective SNR at beta=0.3 band edges
    bank = jnp.asarray(_fd_bank())
    ph = frac * _FD_NPFB
    p_lo = jnp.floor(ph).astype(jnp.int32)
    w = (ph - p_lo)[:, None]
    taps = bank[p_lo] * (1 - w) + bank[p_lo + 1] * w    # [n_syms, 8]
    wins = mf[i0[:, None] + jnp.arange(-_FD_SEMI + 1, _FD_SEMI + 1)[None, :]]
    raw = jnp.sum(wins * taps.astype(mf.dtype), axis=-1)

    # derotate CFO (phase referenced to n0)
    t = pos - n0.astype(jnp.float32)
    syms = raw * jnp.exp(-1j * cfo * t)

    # complex gain from the preamble symbols
    pre = jnp.asarray(p.preamble, dtype=jnp.complex64)
    g = jnp.sum(syms[:PREAMBLE_SYMS] * jnp.conj(pre)) / PREAMBLE_SYMS
    g = jnp.where(jnp.abs(g) > 1e-9, g, 1.0)
    syms = syms / g

    # header, with carrier-phase tracking across its span: the residual
    # CFO after the split-half estimate (~0.002 rad/sample std at 0 dB)
    # drifts ~1 rad over the 264 header symbols, and unlike the payload
    # section there are no pilots to anchor it — measured as a
    # 10-25% header-error floor from -1 to +3 dB.  The preamble symbols
    # (known signs after derotation) anchor the tracker's absolute phase.
    hsyms = syms[PREAMBLE_SYMS:PREAMBLE_SYMS + hdr_syms]
    u_pre = syms[:PREAMBLE_SYMS] * jnp.conj(pre)
    y_tr = jnp.concatenate([u_pre, hsyms])
    sgn_known = jnp.concatenate(
        [jnp.ones((PREAMBLE_SYMS,), jnp.float32),
         jnp.zeros((hdr_syms,), jnp.float32)])
    phi = track_phase_bpsk(y_tr, sgn_known, seg=32, n_iter=2)
    hsyms = hsyms * jnp.exp(-1j * phi[PREAMBLE_SYMS:])
    hdec = modem_mod.demodulate(HEADER_MOD, hsyms)
    if sync.soft:
        # soft header: exact-ML Golay from channel LLRs (~2 dB)
        hllrs = payload_codec.generic_demod_soft(
            hsyms, jnp.int32(HEADER_MOD),
            payload_codec.header_enc_bytes(sync.header_user) * 8)
        (user, plen, mod, f0, f1, check,
         hvalid) = payload_codec.decode_header_soft(
            hllrs, sync.max_payload, len(sync.fecs),
            user_bytes=sync.header_user)
    else:
        hbits = modem_mod.symbols_to_bits(hdec, HEADER_BPS)
        hbytes = payload_codec.header_bits_to_bytes(
            hbits, user_bytes=sync.header_user)
        (user, plen, mod, f0, f1, check,
         hvalid) = payload_codec.decode_header(
            hbytes, sync.max_payload, len(sync.fecs),
            user_bytes=sync.header_user)
    hevm = modem_mod.evm(HEADER_MOD, hsyms, hdec)

    # payload section with per-pilot-segment phase correction
    section = syms[PREAMBLE_SYMS + hdr_syms:]
    data_pos, pilot_pos = slots_layout(sync.max_slots)
    # periodic pilot PN by ordinal (mirrors flex_assemble)
    pil_ref = jnp.asarray(p.pilot_pn, dtype=jnp.complex64)[
        np.arange(len(pilot_pos)) % len(p.pilot_pn)]
    rot = section[jnp.asarray(pilot_pos)] * jnp.conj(pil_ref)
    # pilots beyond this frame's payload may belong to the NEXT burst
    # (full strength, foreign phase): zero them before smoothing so they
    # cannot leak into the last real segment's estimate
    used_pts = payload_codec.payload_points_used(
        sync.fecs, sync.dec_max, sync.enc_max, plen, mod, f0, f1, check)
    n_slots_used = used_pts + -(-used_pts // (PILOT_SPACING - 1))
    seg_valid = jnp.where(hvalid,
                          (n_slots_used + PILOT_SPACING - 1)
                          // PILOT_SPACING,
                          rot.shape[0])
    w_pil = (jnp.arange(rot.shape[0]) < seg_valid).astype(jnp.float32)
    rot = rot * w_pil
    # GLOBAL linear phase-trend fit across the frame's pilots (replaces
    # the round-3 3-pilot smoothing + piecewise-constant segment phase):
    # after CFO derotation the residual common phase is linear in time
    # (constant CFO error + static channel), so a 2-parameter fit uses
    # every pilot — per-symbol phase noise drops from ~1/sqrt(2.7)
    # pilot-decisions to ~1/sqrt(n_pilots), which at 7 dB SNR was worth
    # ~1 dB of QPSK effective-SNR (the measured flex implementation-loss
    # gap vs ofdm/gmsk).  Slope from CASCADED diff-coherent lags
    # (1 -> 8 -> 32): the lag-1 product alone has ~0.05 rad/segment noise
    # at 8 dB, which the global fit amplifies x32 at the frame edges
    # (measured as a PER floor); each longer lag divides the noise by its
    # lag while the previous stage keeps the estimate inside the +-pi/L
    # ambiguity window.  No phase unwrap anywhere; intercept from the
    # slope-derotated mean.
    def _refine(sl, lag):
        if rot.shape[0] <= lag:
            return sl
        acc = jnp.sum(rot[lag:] * jnp.conj(rot[:-lag]) *
                      jnp.exp(-1j * sl * lag))
        return sl + jnp.angle(acc) / lag
    slope = jnp.angle(jnp.sum(rot[1:] * jnp.conj(rot[:-1])))
    slope = _refine(slope, 8)
    slope = _refine(slope, 32)                        # rad/segment
    s_idx = jnp.arange(rot.shape[0], dtype=jnp.float32)
    base = jnp.angle(jnp.sum(rot * jnp.exp(-1j * slope * s_idx)))
    seg = (jnp.asarray(data_pos) // PILOT_SPACING).astype(jnp.float32)
    corr = jnp.exp(-1j * (base + slope * seg))
    data = section[jnp.asarray(data_pos)] * corr

    rssi = 20.0 * jnp.log10(jnp.maximum(jnp.abs(g), 1e-12))
    return (user, data, plen, mod, f0, f1, check, hvalid,
            rssi, hevm, cfo)


def _mf_and_detect(sync: FlexSync, ext: jnp.ndarray):
    """Matched filter + preamble correlation + candidate extraction for one
    extended block; returns ``(mf, metric, c1, c2, detected, locs)``.

    One FFT-domain chain: a single forward FFT of the block feeds the RRC
    matched filter AND both preamble-half correlators (their
    host-precomputed frequency responses compose by multiplication), and
    the energy normalizer is a reshape-cumsum comb moving sum — replacing
    the time-domain complex ``jnp.convolve`` (taps promoted to complex64)
    plus a ``[region, 64]`` strided window gather that materialized 64x
    the stream bytes.  Equivalent to f32 rounding (~1e-6 on the metric,
    same candidates); the old path measured 12.6 ms/16k block on the host
    backend, this one ~3 ms.
    """
    p = sync.params
    k = p.k
    L = ext.shape[0]
    nt = len(p.taps)
    half = PREAMBLE_SYMS // 2
    span = (half - 1) * k + 1
    shift = half * k
    win = k * PREAMBLE_SYMS // 2
    region = sync.block_size + 2 * win + 1

    from ..ops.corr import comb_moving_sum, next_pow2
    nfft = next_pow2(L + nt + span + shift)
    H, G1, G2 = _fe_freq_np(p.k, p.m, p.beta, nfft)
    F = jnp.fft.fft(ext, nfft)
    Fm = F * jnp.asarray(H)
    # mf[n] = full-conv(ext, taps)[n + nt - 1]  (same slice as the old
    # jnp.convolve(..., "full")[nt-1:])
    mf = jnp.fft.ifft(Fm)[nt - 1:nt - 1 + L].astype(jnp.complex64)
    # c_half[n] = sum_i pre_half[i] mf[n + k i] at combined offset
    off = nt - 1 + span - 1
    c1 = jnp.fft.ifft(Fm * jnp.asarray(G1))[
        off:off + region].astype(jnp.complex64)
    c2 = jnp.fft.ifft(Fm * jnp.asarray(G2))[
        off + shift:off + shift + region].astype(jnp.complex64)
    pw = jnp.abs(mf) ** 2
    e_half = comb_moving_sum(pw, half, k, region + shift)
    energy = e_half[:region] + e_half[shift:shift + region]
    # split-half noncoherent combining (|c1|^2 + |c2|^2, the GMSK/OFDM
    # detectors' construction): |c1 + c2|^2 self-cancels once the CFO
    # phase across the halves nears pi (tolerance was ~0.025 rad/sample
    # at k=2 — the least CFO-robust of the three family detectors);
    # splitting doubles it for ~0.7 dB of detection threshold, far below
    # the payload-FEC waterfall
    metric = (jnp.abs(c1) ** 2 + jnp.abs(c2) ** 2) / \
        (jnp.maximum(energy, 1e-12) * (PREAMBLE_SYMS // 2))
    # silence gate
    floor = 1e-4 * PREAMBLE_SYMS * (jnp.mean(pw) + 1e-12)
    metric = jnp.where(energy > floor, metric, 0.0)

    detected, locs = _find_candidates(sync, metric)
    return mf, metric, c1, c2, detected, locs


def _gated_decode(sync: FlexSync, mf, metric, gate, locs, c1_at, c2_at,
                  per_candidate_source: bool = False):
    """``lax.cond``-gated batched candidate decode (see
    ofdm_sync._gated_decode).  ``locs``/``c1_at``/``c2_at`` are flat
    ``[R]``; with ``per_candidate_source`` the ``mf``/``metric`` arrays
    carry a leading ``[R]`` axis (one per candidate)."""
    R = locs.shape[0]
    src_axis = 0 if per_candidate_source else None

    def do_decode(args):
        locs_, c1_, c2_ = args
        (user, points, plen, mod, f0, f1, check, hvalid, rssi, hevm,
         cfo) = jax.vmap(
            lambda m, mt, n0, a1, a2: _decode_candidate(sync, m, mt, n0,
                                                        a1, a2),
            in_axes=(src_axis, src_axis, 0, 0, 0))(mf, metric, locs_,
                                                   c1_, c2_)
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
            hevm, payload_codec.payload_evm_mse(points, mod, used), used,
            hdr_syms=payload_codec.header_syms(sync.header_user))
        evm = jnp.where(hvalid, evm, hevm)
        return (user, payload, plen, mod, f0, f1, check, hvalid, pvalid,
                rssi, evm, cfo)

    def skip_decode(args):
        f32 = jnp.float32
        return (jnp.zeros((R, sync.header_user), jnp.uint8),
                jnp.zeros((R, sync.max_payload), jnp.uint8),
                jnp.zeros((R,), jnp.int32), jnp.zeros((R,), jnp.int32),
                jnp.zeros((R,), jnp.int32), jnp.zeros((R,), jnp.int32),
                jnp.zeros((R,), jnp.int32), jnp.zeros((R,), bool),
                jnp.zeros((R,), bool), jnp.zeros((R,), f32),
                jnp.zeros((R,), f32), jnp.zeros((R,), f32))

    return jax.lax.cond(gate, do_decode, skip_decode, (locs, c1_at, c2_at))


def flex_sync_block(sync: FlexSync, state: FlexSyncState, block: jnp.ndarray):
    """Process ``block_size`` samples -> (state', FlexResults)."""
    block = iqfmt.iq_from_any(block)      # accepts [2, bs] bf16 planes
    ext = jnp.concatenate([state.tail, block])
    # matched filter (stateless on ext: overlap >> filter length)
    mf, metric, c1, c2, detected, locs = _mf_and_detect(sync, ext)

    (user, payload, plen, mod, f0, f1, check, hvalid, pvalid, rssi, hevm,
     cfo) = _gated_decode(sync, mf, metric, jnp.any(detected), locs,
                          c1[locs], c2[locs])

    res = FlexResults(
        detected=detected,
        header_valid=detected & hvalid,
        payload_valid=detected & pvalid,
        header=user, payload=payload,
        payload_len=jnp.where(detected, plen, 0),
        mod=mod, fec0=f0, fec1=f1, check=check,
        rssi=rssi, evm=hevm, cfo=cfo,
        t_start=state.base + locs.astype(jnp.int32),
    )
    new_state = FlexSyncState(
        tail=ext[ext.shape[0] - sync.overlap:],
        base=state.base + sync.block_size)
    return new_state, res


def make_flex_sync_step(sync: FlexSync):
    @jax.jit
    def step(state, block):
        return flex_sync_block(sync, state, block)
    return step


def flex_sync_blocks_batched(sync: FlexSync, state: FlexSyncState,
                             blocks: jnp.ndarray):
    """Multi-block batched dispatch: ``blocks [n_blocks, block_size]`` ->
    ``(state', FlexResults with leading [n_blocks, max_frames])``.

    Same construction as :func:`ofdm_sync.sync_blocks_batched`: the
    matched-filter + detect front-end vmaps over strided stream windows
    (each identical to what the sequential path sees), and every
    candidate decodes against its own block's mf/metric arrays — results
    are bit-identical to a scan of :func:`flex_sync_block` on the
    DETECTED rows (masks, t_start, payloads, carried state); undetected
    rows' unmasked fields differ because the scan's per-block decode
    gate zeroes them for detection-free blocks."""
    blocks = iqfmt.iq_from_any(blocks)    # accepts [2, n_blocks, bs] planes
    n_blocks, bs = blocks.shape
    assert bs == sync.block_size
    K = sync.max_frames
    full = jnp.concatenate([state.tail, blocks.reshape(-1)])
    w_idx = (jnp.arange(n_blocks) * bs)[:, None] + \
        jnp.arange(sync.overlap + bs)[None, :]
    exts = full[w_idx]                              # [n_blocks, overlap+bs]

    mf, metric, c1, c2, detected, locs = jax.vmap(
        lambda e: _mf_and_detect(sync, e))(exts)

    blk_of = jnp.repeat(jnp.arange(n_blocks), K)
    locs_f = locs.reshape(-1)
    (user, payload, plen, mod, f0, f1, check, hvalid, pvalid, rssi, hevm,
     cfo) = _gated_decode(
        sync, mf[blk_of], metric[blk_of], jnp.any(detected), locs_f,
        c1[blk_of, locs_f], c2[blk_of, locs_f], per_candidate_source=True)

    def rs(v):
        return v.reshape((n_blocks, K) + v.shape[1:])

    res = FlexResults(
        detected=detected,
        header_valid=detected & rs(hvalid),
        payload_valid=detected & rs(pvalid),
        header=rs(user), payload=rs(payload),
        payload_len=jnp.where(detected, rs(plen), 0),
        mod=rs(mod), fec0=rs(f0), fec1=rs(f1), check=rs(check),
        rssi=rs(rssi), evm=rs(hevm), cfo=rs(cfo),
        t_start=(state.base + jnp.arange(n_blocks, dtype=jnp.int32)[:, None]
                 * bs + locs.astype(jnp.int32)),
    )
    new_state = FlexSyncState(
        tail=full[full.shape[0] - sync.overlap:],
        base=state.base + jnp.int32(n_blocks * bs))
    return new_state, res
