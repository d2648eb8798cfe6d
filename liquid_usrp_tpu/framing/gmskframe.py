"""GMSK framing — continuous-phase modulation TX + batched differential RX.

Capability parity: ``gmskframegen``/``gmskframesync`` — Gaussian MSK frames
with preamble + FEC/CRC header + payload, k=2 samples/symbol
(/root/reference/src/gmskframe_tx.cc:163-225 defaults CRC16 / Hamming(7,4) /
200 B payload at :63-66; RX chain /root/reference/src/gmskframe_rx.cc:
191-256 with SNR/PER reporting).

Format (from scratch):

* preamble: 64 alternating bits (clock recovery) + 64 balanced PN sync bits,
* header: shared codec header (Golay(24,12)+CRC16) as raw GMSK bits,
* payload: shared codec payload byte stream as raw GMSK bits (modulation is
  the constant-envelope GMSK itself — 1 bit/symbol; the header's ``mod``
  field is pinned to BPSK so the shared codec demaps signs directly),
* modulation: bits -> NRZ (bit0 -> +1) -> Gaussian phase pulse (BT
  selectable, 0.5 default) -> phase accumulation (pi/2 per symbol) ->
  ``exp(j phi)``.

Block design: TX phase is one ``cumsum`` over the filtered impulse train; RX
runs an FFT-domain Laurent matched filter over the whole block, correlates
the known template segmented-coherently at every offset (one dilated real
convolution), and decodes candidates under ``vmap`` with the shared codec
(treating derotated MF samples as pseudo-BPSK points, carrier-tracked by
``phase_track.track_phase_bpsk``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import iqfmt
from ..ops import modem as modem_mod
from ..utils.bits import unpack_bits
from . import payload as payload_codec
from .ofdm import FrameProps
from .payload import EXPANSION as _EXPANSION

__all__ = [
    "GmskParams", "make_gmsk_params", "gmsk_assemble", "gmsk_frame_length",
    "GmskSync", "make_gmsk_sync", "gmsk_sync_init", "gmsk_sync_block",
    "make_gmsk_sync_step", "gmsk_sync_blocks_batched", "gmsk_default_props",
]

PRE_BITS = 64
SYNC_BITS = 64
# detector coherence-segment length (symbols): coherent integration within
# a segment, noncoherent |.|^2 combining across segments.  CFO tolerance
# ~ pi/(DETECT_SEG*k) rad/sample (0.098 at k=2) — far above any residual
# CFO in this system; the coherent gain inside each segment buys ~2-3 dB
# of detection sensitivity over the round-2 differential-phase metric
# (which applies a hard angle() nonlinearity per sample before
# correlating, suffering the classic discriminator click-noise loss
# below ~5 dB).
DETECT_SEG = 16


def gmsk_default_props() -> FrameProps:
    """GMSK app defaults: CRC16 + Hamming(7,4)
    (/root/reference/src/gmskframe_tx.cc:63-66)."""
    from ..ops import crc as crc_mod
    from ..ops import fec as fec_mod
    return FrameProps(check=crc_mod.CRC_16, fec0=fec_mod.FEC_NONE,
                      fec1=fec_mod.FEC_HAMMING74,
                      mod=modem_mod.MOD_BPSK)


class GmskParams(NamedTuple):
    k: int                 # samples per symbol
    m: int                 # gaussian pulse semi-length (symbols)
    bt: float
    pulse: np.ndarray      # [2*k*m+1] float32, sums to 1 (phase pulse)
    template: np.ndarray   # [PRE_BITS + SYNC_BITS] float32 NRZ +-1
    c0: np.ndarray         # [Lc] complex64 empirical linear (Laurent) pulse
    a_ref: np.ndarray      # [PRE_BITS+SYNC_BITS] complex64 template symbols
    sgn: np.ndarray        # [PRE_BITS+SYNC_BITS] float32 derotated signs
    mf_lag: int            # sample lag: detector offset -> MF symbol center


def _gmsk_waveform_np(nrz: np.ndarray, k: int, pulse: np.ndarray):
    """Host-side reference modulator (mirrors gmsk_assemble)."""
    imp = np.zeros(len(nrz) * k)
    imp[::k] = nrz
    freq = np.convolve(imp, pulse, mode="same")
    phase = (np.pi / 2) * np.cumsum(freq)
    return np.exp(1j * phase)


def _fit_c0(k: int, m: int, pulse: np.ndarray) -> np.ndarray:
    """Empirical linearization: least-squares fit of the GMSK waveform as
    a linear PAM ``x[n] ~= sum_m a_m c0[n - m k]`` with the known CPM
    symbols ``a_m = exp(j pi/2 cumsum(nrz))``.

    For h=1/2 CPM the Laurent decomposition guarantees the main pulse
    carries ~99% of the energy at BT >= 0.3; fitting it numerically (once,
    host-side) sidesteps closed-form Laurent bookkeeping AND absorbs this
    modulator's exact pulse alignment conventions.
    """
    rng = np.random.default_rng(0xC0FEE)
    nb = 1024
    nrz = rng.choice(np.array([-1.0, 1.0]), nb)
    x = _gmsk_waveform_np(nrz, k, pulse)
    a = np.exp(1j * (np.pi / 2) * np.cumsum(nrz))
    a_up = np.zeros(nb * k, np.complex128)
    a_up[::k] = a
    Lc = (4 * m + 3) * k + 1
    off = Lc // 2
    cols = []
    for j in range(Lc):
        cols.append(np.roll(a_up, j - off))
    A = np.stack(cols, axis=1)
    rows = slice(Lc, nb * k - Lc)
    c0, *_ = np.linalg.lstsq(A[rows], x[rows], rcond=None)
    return c0


@functools.lru_cache(maxsize=None)
def make_gmsk_params(k: int = 2, m: int = 3, bt: float = 0.5) -> GmskParams:
    from ..ops.filter_design import gaussian_pulse
    rng = np.random.default_rng(0x6A5C0001)
    pre = np.array([1 - 2 * (i % 2) for i in range(PRE_BITS)], dtype=np.int8)
    # balanced PN syncword (zero sum => clean CFO estimation)
    sw = np.concatenate([np.ones(SYNC_BITS // 2), -np.ones(SYNC_BITS // 2)])
    rng.shuffle(sw)
    template = np.concatenate([pre, sw]).astype(np.float32)
    pulse = gaussian_pulse(k, m, bt)
    c0 = _fit_c0(k, m, pulse)
    n_t = PRE_BITS + SYNC_BITS
    S = np.cumsum(template.astype(np.float64))
    a_ref = np.exp(1j * (np.pi / 2) * S)
    # (S_n - n) is even for +-1 increments => a_ref * (-j)^n is +-1 real
    sgn = np.real(a_ref * (-1j) ** (np.arange(1, n_t + 1))).round()

    # calibrate the constant lag between the detector's peak offset and
    # the MF symbol centers (absorbs every alignment convention): run the
    # detector's own metric — the segmented-coherent MF correlation, the
    # SAME math as _front_end — on a clean frame to find n0_det, then
    # find the MF sampling lag that best matches a_ref
    pad = 16 * k
    frame_nrz = np.concatenate([template, rng.choice([-1.0, 1.0], 64)])
    x = np.concatenate([
        np.ones(pad, np.complex128),
        _gmsk_waveform_np(np.concatenate([frame_nrz, np.zeros(2 * m)]),
                          k, pulse)])
    mf = np.convolve(x, np.conj(c0[::-1]), mode="same")
    offs = np.arange(pad + 4 * k)
    wz = mf[offs[:, None] + k * np.arange(n_t)[None, :]]
    n_seg = n_t // DETECT_SEG
    u = (wz * np.conj(a_ref)[None, :]).reshape(-1, n_seg, DETECT_SEG)
    ez = (np.abs(wz) ** 2).reshape(-1, n_seg, DETECT_SEG).sum(-1)
    ea = (np.abs(a_ref) ** 2).reshape(n_seg, DETECT_SEG).sum(-1)
    num = (np.abs(u.sum(-1)) ** 2).sum(-1)
    den = np.maximum((ez * ea[None, :]).sum(-1), 1e-12)
    n0_det = int(np.argmax(num / den))
    best, mf_lag = -1.0, 0
    for lag in range(-4 * k, 4 * k + 1):
        idx = n0_det + lag + k * np.arange(n_t)
        if idx[0] < 0 or idx[-1] >= len(mf):
            continue
        v = abs(np.vdot(a_ref, mf[idx]))
        if v > best:
            best, mf_lag = v, lag
    return GmskParams(k=k, m=m, bt=bt,
                      pulse=pulse.astype(np.float32),
                      template=template,
                      c0=c0.astype(np.complex64),
                      a_ref=a_ref.astype(np.complex64),
                      sgn=sgn.astype(np.float32),
                      mf_lag=int(mf_lag))


def _frame_bits(props: FrameProps, header: jnp.ndarray,
                payload: jnp.ndarray) -> jnp.ndarray:
    henc = payload_codec.encode_header(header, payload.shape[-1], props)
    penc = payload_codec.encode_payload(props, payload)
    return jnp.concatenate([unpack_bits(henc), unpack_bits(penc)])


def data_bits_count(props: FrameProps, payload_len: int) -> int:
    return (payload_codec.HEADER_ENC_BYTES +
            payload_codec.payload_enc_bytes(props, payload_len)) * 8


def gmsk_frame_length(params: GmskParams, props: FrameProps,
                      payload_len: int) -> int:
    n_bits = PRE_BITS + SYNC_BITS + data_bits_count(props, payload_len)
    return (n_bits + 2 * params.m) * params.k


def gmsk_assemble(params: GmskParams, props: FrameProps,
                  header: jnp.ndarray, payload: jnp.ndarray,
                  expansion: int = payload_codec.EXPANSION,
                  rx_max_payload: int = None) -> jnp.ndarray:
    """Assemble one GMSK burst -> complex64 ``[gmsk_frame_length]``.

    ``expansion``/``rx_max_payload`` describe the receiving sync's decode
    budget (see payload.check_budget)."""
    payload_codec.check_budget(props, payload.shape[-1], expansion,
                               rx_max_payload)
    bits = _frame_bits(props, header, payload)
    # differential precoding (GSM-style): the coherent receiver's
    # derotated decision j^(S_q - q) then equals (-1)^bit directly, so
    # BPSK decisions recover the original bits with no differential
    # error doubling
    bits = bits ^ jnp.concatenate(
        [jnp.zeros((1,), bits.dtype), bits[:-1]])
    nrz = (1.0 - 2.0 * bits.astype(jnp.float32))
    tmpl = jnp.asarray(params.template)
    sym = jnp.concatenate([tmpl, nrz,
                           jnp.zeros(2 * params.m, dtype=jnp.float32)])
    k = params.k
    # impulse train -> gaussian phase pulse -> pi/2-per-symbol phase ramp
    imp = jnp.zeros((sym.shape[0] * k,), dtype=jnp.float32)
    imp = imp.at[::k].set(sym)
    # pulse sums to 1, so each symbol contributes pi/2 * nrz total phase
    freq = jnp.convolve(imp, jnp.asarray(params.pulse), mode="same")
    phase = (np.pi / 2) * jnp.cumsum(freq)
    return jnp.exp(1j * phase).astype(jnp.complex64)


# ---------------------------------------------------------------------------
# synchronizer
# ---------------------------------------------------------------------------

class GmskSync(NamedTuple):
    params: GmskParams
    block_size: int
    max_payload: int
    max_frames: int
    threshold: float
    overlap: int
    max_bits: int            # header+payload bit budget
    dec_max: int
    enc_max: int
    fecs: tuple = payload_codec.PAYLOAD_FECS
    soft: bool = False


class GmskSyncState(NamedTuple):
    tail: jnp.ndarray
    base: jnp.ndarray


def make_gmsk_sync(params: GmskParams, block_size: int = 16384,
                   max_payload: int = 2048, max_frames: int = 8,
                   threshold: float = 0.38, enable_conv: bool = False,
                   soft: bool = False,
                   expansion: int = _EXPANSION) -> GmskSync:
    # threshold 0.38 on the sqrt(m1*m2) composite (was 0.5 on m1 alone):
    # the old default was the detection limiter below -2 dB (det 18/40
    # at -3 dB).  At 0.38 the composite detects 40/40 at -3 dB and most
    # frames at -4, with measured margins: data-region sidelobes <= 0.34
    # (the diff-coherent m2 term collapses them), pure noise <= 0.15 over
    # 500k samples (measured on the host)
    if expansion < 1:
        raise ValueError(f"expansion must be >= 1 (got {expansion})")
    dec_max = max_payload + 4
    enc_max = expansion * dec_max   # see payload.check_budget
    max_bits = (payload_codec.HEADER_ENC_BYTES + enc_max) * 8
    max_frame = (PRE_BITS + SYNC_BITS + max_bits + 4 * params.m) * params.k
    fecs = (payload_codec.PAYLOAD_FECS_FULL if enable_conv
            else payload_codec.PAYLOAD_FECS)
    # overlap margin beyond the frame: the +-4k mf_lag search plus the
    # fractional-delay interpolation read one sample past the last
    # symbol.  8k alone left small-m geometries (m=1) short by ~3k
    # samples — the tail read clipped at the buffer edge and the final
    # CRC bits intermittently decoded as garbage; 24k covers every m.
    return GmskSync(params=params, block_size=block_size,
                    max_payload=max_payload, max_frames=max_frames,
                    threshold=threshold, overlap=max_frame + 24 * params.k,
                    max_bits=max_bits, dec_max=dec_max, enc_max=enc_max,
                    fecs=fecs, soft=soft)


def gmsk_sync_init(sync: GmskSync) -> GmskSyncState:
    return GmskSyncState(
        tail=jnp.zeros((sync.overlap,), jnp.complex64),
        base=jnp.int32(-sync.overlap))


def _diff_phase(x: jnp.ndarray) -> jnp.ndarray:
    """d[n] = angle(x[n] conj(x[n-1])) with d[0] = 0."""
    d = jnp.angle(x[1:] * jnp.conj(x[:-1]))
    return jnp.concatenate([jnp.zeros((1,), d.dtype), d])


@functools.lru_cache(maxsize=None)
def _mf_freq_np(k: int, m: int, bt: float, nfft: int) -> np.ndarray:
    """Host-precomputed frequency response of the Laurent MF (conjugated,
    time-reversed ``c0``) for FFT-domain convolution."""
    p = make_gmsk_params(k, m, bt)
    return np.fft.fft(np.conj(p.c0[::-1]).astype(np.complex64), nfft)


@functools.lru_cache(maxsize=None)
def _detect_kernel_np(k: int, m: int, bt: float) -> np.ndarray:
    """Per-segment template-correlation conv kernels ``[2 n_seg, 2, D]``:
    output channel 2s / 2s+1 is Re/Im of segment s's correlation, input
    channels are Re/Im of the MF stream (complex conv decomposed into one
    real grouped conv)."""
    p = make_gmsk_params(k, m, bt)
    n_seg = (PRE_BITS + SYNC_BITS) // DETECT_SEG
    A = np.conj(p.a_ref.reshape(n_seg, DETECT_SEG))
    rhs = np.zeros((2 * n_seg, 2, DETECT_SEG), np.float32)
    rhs[0::2, 0] = A.real
    rhs[0::2, 1] = -A.imag
    rhs[1::2, 0] = A.imag
    rhs[1::2, 1] = A.real
    return rhs


def _front_end(sync: GmskSync, ext: jnp.ndarray):
    """Laurent matched filter + segmented-coherent template correlation +
    candidate extraction for one extended block; returns
    ``(z, metric, detected, locs)``.

    Detection metric: the MF output ``z`` strided at symbol spacing is
    correlated against the known template waveform ``a_ref`` coherently
    within ``DETECT_SEG``-symbol segments and |.|^2-combined across
    segments — invariant to carrier phase/gain, CFO-tolerant to
    ~pi/(DETECT_SEG*k) rad/sample, and (by per-segment Cauchy-Schwarz)
    normalized to [0, 1] with a 1/DETECT_SEG noise floor.  Replaces the
    round-2 differential-phase metric, whose per-sample angle()
    nonlinearity cost ~2-3 dB of detection sensitivity at low SNR — the
    proven waterfall bottleneck for conv-coded GMSK (docs/ber_gmsk_v27:
    every *detected* frame decoded payload-exact while detection itself
    fell off below 4 dB).

    Implementation: the MF runs in the FFT domain (3x the speed of the
    time-domain complex conv on the host backend; the kernel's FFT is a
    host-side constant).  The segmented correlation is ONE dilated real
    convolution (taps at symbol stride k) whose per-segment output rows
    are shifted slices — replacing the ``[n_metric, n_t]`` strided window
    gather, which materialized 128x the stream bytes three times over
    (the whole-block memory-traffic hot spot).  Equivalent to the gather
    formulation to f32 rounding (~1e-7 metric delta, same candidates).
    """
    from .ofdm_sync import topk_peaks
    p = sync.params
    k = p.k
    # z sampled at symbol centers is ~ G * j^cumsum(nrz) per the linear
    # PAM model fitted in _fit_c0; both detection and decode run on it.
    from ..ops.corr import comb_moving_sum, next_pow2
    L = ext.shape[0]
    Lc = p.c0.shape[0]
    nfft = next_pow2(L + Lc)
    H = jnp.asarray(_mf_freq_np(p.k, p.m, p.bt, nfft))
    start = (Lc - 1) // 2
    z = jnp.fft.ifft(jnp.fft.fft(ext, nfft) * H)[start:start + L]
    z = z.astype(jnp.complex64)

    n_t = PRE_BITS + SYNC_BITS
    n_seg = n_t // DETECT_SEG
    region = sync.block_size
    n_metric = region + 2 * (k * 16) + 1   # region inset + NMS lookahead
    shift = DETECT_SEG * k
    w_out = n_metric + (n_seg - 1) * shift
    w_in = w_out + (DETECT_SEG - 1) * k
    zt = z[:w_in]
    lhs = jnp.stack([jnp.real(zt), jnp.imag(zt)])[None]    # [1, 2, w_in]
    out = jax.lax.conv_general_dilated(
        lhs, jnp.asarray(_detect_kernel_np(p.k, p.m, p.bt)),
        window_strides=(1,), padding="VALID", rhs_dilation=(k,),
        dimension_numbers=("NCW", "OIW", "NCW"))[0]        # [2 n_seg, w_out]
    e_out = comb_moving_sum(jnp.abs(zt) ** 2, DETECT_SEG, k, w_out)
    ea = np.sum(np.abs(p.a_ref.reshape(n_seg, DETECT_SEG)) ** 2, axis=-1)
    num = jnp.zeros((n_metric,), jnp.float32)
    den = jnp.zeros((n_metric,), jnp.float32)
    # differentially-coherent cross-segment term: every c_{s+1} conj(c_s)
    # product rotates by the SAME e^{j cfo shift}, so |sum| is CFO-
    # invariant like the square-law term — but a data-region sidelobe's
    # per-segment phases are incoherent, so it collapses there (measured:
    # true frames m2 ~ m1; data sidelobes m2 ~ 0.1 at m1 ~ 0.5)
    num2 = jnp.zeros((n_metric,), jnp.complex64)
    den2 = jnp.zeros((n_metric,), jnp.float32)
    prev_c = prev_e = None
    for s in range(n_seg):
        sl = slice(s * shift, s * shift + n_metric)
        cs = out[2 * s, sl] + 1j * out[2 * s + 1, sl]
        es = float(ea[s]) * e_out[sl]
        num = num + jnp.abs(cs) ** 2
        den = den + es
        if prev_c is not None:
            num2 = num2 + cs * jnp.conj(prev_c)
            den2 = den2 + jnp.sqrt(jnp.maximum(es * prev_e, 0.0))
        prev_c, prev_e = cs, es
    m1 = num / jnp.maximum(den, 1e-12)
    m2 = jnp.abs(num2) / jnp.maximum(den2, 1e-12)
    # geometric mean: keeps m1's per-segment Cauchy-Schwarz normalization
    # AND m2's phase-consistency requirement.  Measured separation (see
    # make_gmsk_sync threshold note): true frames >= 0.41 at -3 dB SNR
    # (>= 0.32 at -5), data-region sidelobes <= 0.34 over 6 streams,
    # pure-noise max 0.15 over 500k samples.
    metric = jnp.sqrt(jnp.maximum(m1 * m2, 0.0))
    # energy-balance gate: at a signal->silence seam only part of the
    # template span carries energy, and the scale-invariant ratios can
    # spike on the few live segments.  A full template span has
    # den2 ~ 0.875*den (AM-GM equality at equal segment energies); a
    # partially-covered span collapses den2 (sqrt of a near-zero
    # neighbor), so gating at 0.4*den kills seam artifacts at 2x margin
    # without touching real frames (measured: one seam false alarm per
    # ~300k samples at -2 dB before the gate, none after).
    metric = jnp.where(den2 > 0.4 * den, metric, 0.0)
    # silence gate: require real signal power in the raw samples
    pwr = jnp.abs(ext[: n_metric]) ** 2
    floor = 1e-3 * (jnp.mean(jnp.abs(ext) ** 2) + 1e-12)
    metric = jnp.where(pwr > floor, metric, 0.0)

    win = k * 16
    from ..ops.corr import sliding_max
    local_max = sliding_max(metric, win)
    is_peak = (metric >= local_max) & (metric > sync.threshold)
    idx = jnp.arange(metric.shape[0])
    # detect region inset by the NMS radius (see ofdm_sync)
    score = jnp.where(is_peak & (idx >= win) & (idx < region + win),
                      metric, -1.0)
    vals, locs = topk_peaks(score, sync.max_frames, 2 * win + 1)
    return z, metric, vals > 0, locs


def _gated_decode(sync: GmskSync, z, metric, ext, gate, locs,
                  per_candidate_source: bool = False):
    """``lax.cond``-gated batched candidate decode (see
    flexframe_sync._gated_decode).  With ``per_candidate_source`` the
    ``z``/``metric``/``ext`` arrays carry a leading ``[R]`` axis (one row
    per candidate in flat ``locs``)."""
    p = sync.params
    k = p.k
    n_t = PRE_BITS + SYNC_BITS
    R = locs.shape[0]
    src_axis = 0 if per_candidate_source else None

    def decode(z, metric, ext, n0):
        # fractional timing via parabolic fit
        m_m1 = metric[jnp.clip(n0 - 1, 0, metric.shape[0] - 1)]
        m_0 = metric[n0]
        m_p1 = metric[jnp.clip(n0 + 1, 0, metric.shape[0] - 1)]
        den = m_m1 - 2 * m_0 + m_p1
        delta = jnp.where(jnp.abs(den) > 1e-9,
                          0.5 * (m_m1 - m_p1) / den, 0.0)
        delta = jnp.clip(delta, -0.5, 0.5)
        n_all = n_t + sync.max_bits
        pos = n0.astype(jnp.float32) + delta + p.mf_lag + k * jnp.arange(
            n_all, dtype=jnp.float32)
        i0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, z.shape[0] - 2)
        frac = pos - i0.astype(jnp.float32)
        zs = z[i0] * (1 - frac) + z[i0 + 1] * frac   # [n_all] complex
        rel = pos - pos[n_t // 2]
        # CFO from the MF-domain template (the discriminator-DC estimate is
        # far too noisy to derotate with: std ~0.03 rad/sample at 8 dB).
        # Stage 1: periodogram peak of u = zs conj(a_ref) — u is a complex
        # sinusoid at the residual CFO, so the zero-padded FFT peak is the
        # near-ML frequency estimate with the full 128-symbol coherent
        # gain.  (The previous adjacent-symbol-product estimator had a
        # noise std of ~0.035 rad/sample at 0 dB — beyond the +-pi/(n_t k)
        # ambiguity of stage 2, which then wrapped and collapsed the V&V
        # tracking; measured as the 10/40 header-failure floor at 0 dB.)
        # Stage 2: split-half phase slope for precision.
        aref = jnp.asarray(p.a_ref)
        u = zs[:n_t] * jnp.conj(aref)
        NF = 512
        U2 = jnp.abs(jnp.fft.fft(u, NF)) ** 2
        pk = jnp.argmax(U2).astype(jnp.int32)
        # parabolic sub-bin interpolation (wrap-indexed neighbors)
        um = U2[jnp.mod(pk - 1, NF)]
        u0 = U2[pk]
        up = U2[jnp.mod(pk + 1, NF)]
        den1 = um - 2 * u0 + up
        dsub = jnp.where(jnp.abs(den1) > 1e-12,
                         0.5 * (um - up) / den1, 0.0)
        dsub = jnp.clip(dsub, -0.5, 0.5)
        f = (pk.astype(jnp.float32) + dsub) / NF
        f = jnp.where(f > 0.5, f - 1.0, f)   # cycles/symbol-sample
        dw1 = 2 * np.pi * f / k
        zs = zs * jnp.exp(-1j * dw1 * rel)
        u = zs[:n_t] * jnp.conj(aref)
        G1 = jnp.mean(u[: n_t // 2])
        G2 = jnp.mean(u[n_t // 2:])
        dw2 = jnp.angle(G2 * jnp.conj(G1)) / ((n_t // 2) * k)
        zs = zs * jnp.exp(-1j * dw2 * rel)
        dw = dw1 + dw2
        G = jnp.mean(zs[:n_t] * jnp.conj(aref))
        Gm = jnp.maximum(jnp.abs(G), 1e-9)
        # derotate the pi/2-per-symbol CPM rotation: j^(S_q - q) is real
        # (+-1) for the precoded stream.  (-j)^q via an exact 4-cycle table.
        q = jnp.arange(1, n_all + 1)
        rot = jnp.asarray(np.array([1, -1j, -1, 1j], np.complex64))[q % 4]
        y = zs * (jnp.conj(G) / Gm) * rot
        # Blockwise phase tracking: the template-only carrier estimate
        # leaves a residual CFO whose phase walks off over a long frame.
        # V&V seed + data-aided refinement anchored to the known template
        # signs (see phase_track.track_phase_bpsk; at 0-1 dB bare V&V
        # slipped by pi between segments, flipping every later sign —
        # the measured header-error limiter once detection held).
        from .phase_track import track_phase_bpsk
        sgn_known = jnp.concatenate(
            [jnp.asarray(p.sgn),
             jnp.zeros((n_all - n_t,), jnp.float32)])
        corr_ph = track_phase_bpsk(y, sgn_known, seg=32, n_iter=2)
        y = y * jnp.exp(-1j * corr_ph)
        samp = jnp.real(y) / Gm
        # amplitude/noise reference against the known template signs
        sgn = jnp.asarray(p.sgn)
        amp = jnp.sum(samp[:n_t] * sgn) / n_t
        amp = jnp.where(jnp.abs(amp) > 1e-9, amp, 1.0)
        pts = (samp / amp).astype(jnp.complex64)    # pseudo-BPSK points
        data = pts[n_t:]
        hbits_pts = data[: payload_codec.HEADER_ENC_BYTES * 8]
        if sync.soft:
            # soft header: exact-ML Golay from channel LLRs (~2 dB) — at
            # 0-1 dB the hard Golay header was the proven residual
            # bottleneck once detection held (docs/ber_gmsk_v27)
            hllrs = payload_codec.generic_demod_soft(
                hbits_pts, jnp.int32(modem_mod.MOD_BPSK),
                payload_codec.HEADER_ENC_BYTES * 8)
            user, plen, mod_f, f0, f1, check, hvalid = \
                payload_codec.decode_header_soft(hllrs, sync.max_payload,
                                                 len(sync.fecs))
        else:
            hsym = modem_mod.demodulate(modem_mod.MOD_BPSK, hbits_pts)
            hbits = hsym.astype(jnp.uint8)
            hbytes = payload_codec.header_bits_to_bytes(hbits)
            user, plen, mod_f, f0, f1, check, hvalid = \
                payload_codec.decode_header(hbytes, sync.max_payload,
                                            len(sync.fecs))
        # payload: GMSK is 1 bit/symbol regardless of the header mod field
        ppts = data[payload_codec.HEADER_ENC_BYTES * 8:]
        snr_est = 10.0 * jnp.log10(
            jnp.maximum(amp ** 2 / jnp.maximum(
                jnp.mean((samp[:n_t] - amp * sgn) ** 2), 1e-9), 1e-9))
        # RSSI averaged over the whole preamble-template span (a single
        # sample's power carries the full noise variance — several dB of
        # frame-to-frame scatter)
        ridx = jnp.clip(n0 + jnp.arange(n_t * k), 0, ext.shape[0] - 1)
        rssi = 10.0 * jnp.log10(jnp.maximum(
            jnp.mean(jnp.abs(ext[ridx]) ** 2), 1e-12))
        evm = -snr_est
        cfo_rad = dw  # rad/sample (MF-domain template estimate)
        return (user, ppts, plen, mod_f, f0, f1, check, hvalid,
                rssi, evm, cfo_rad)

    def skip_decode(locs_):
        f32 = jnp.float32
        return (jnp.zeros((R, 8), jnp.uint8),
                jnp.zeros((R, sync.max_payload), jnp.uint8),
                jnp.zeros((R,), jnp.int32), jnp.zeros((R,), jnp.int32),
                jnp.zeros((R,), jnp.int32), jnp.zeros((R,), jnp.int32),
                jnp.zeros((R,), jnp.int32), jnp.zeros((R,), bool),
                jnp.zeros((R,), bool), jnp.zeros((R,), f32),
                jnp.zeros((R,), f32), jnp.zeros((R,), f32))

    def do_decode(locs_):
        (user, ppts, plen, mod_f, f0, f1, check, hvalid, rssi, evm,
         cfo) = jax.vmap(
            decode, in_axes=(src_axis, src_axis, src_axis, 0))(
            z, metric, ext, locs_)
        # GMSK payload is 1 bit/symbol regardless of the header mod field
        mod_bpsk = jnp.full((R,), modem_mod.MOD_BPSK, dtype=jnp.int32)
        decode_fn = (payload_codec.decode_payload_batch_soft if sync.soft
                     else payload_codec.decode_payload_batch)
        payload, pvalid = decode_fn(
            sync.enc_max, sync.dec_max, sync.max_payload,
            ppts, mod_bpsk, f0, f1, check, plen, hvalid, sync.fecs)
        return (user, payload, plen, mod_f, f0, f1, check, hvalid, pvalid,
                rssi, evm, cfo)

    return jax.lax.cond(gate, do_decode, skip_decode, locs)


def gmsk_sync_block(sync: GmskSync, state: GmskSyncState,
                    block: jnp.ndarray):
    """Process ``block_size`` samples -> (state', FlexResults-like)."""
    from .flexframe_sync import FlexResults
    block = iqfmt.iq_from_any(block)      # accepts [2, bs] bf16 planes
    ext = jnp.concatenate([state.tail, block])
    z, metric, detected, locs = _front_end(sync, ext)
    (user, payload, plen, mod_f, f0, f1, check, hvalid, pvalid, rssi, evm,
     cfo) = _gated_decode(sync, z, metric, ext, jnp.any(detected), locs)

    res = FlexResults(
        detected=detected,
        header_valid=detected & hvalid,
        payload_valid=detected & pvalid,
        header=user, payload=payload,
        payload_len=jnp.where(detected, plen, 0),
        mod=mod_f, fec0=f0, fec1=f1, check=check,
        rssi=rssi, evm=evm, cfo=cfo,
        t_start=state.base + locs.astype(jnp.int32))
    new_state = GmskSyncState(
        tail=ext[ext.shape[0] - sync.overlap:],
        base=state.base + sync.block_size)
    return new_state, res


def make_gmsk_sync_step(sync: GmskSync):
    @jax.jit
    def step(state, block):
        return gmsk_sync_block(sync, state, block)
    return step


def gmsk_sync_blocks_batched(sync: GmskSync, state: GmskSyncState,
                             blocks: jnp.ndarray):
    """Multi-block batched dispatch: ``blocks [n_blocks, block_size]`` ->
    ``(state', FlexResults with leading [n_blocks, max_frames])``.

    Same construction as :func:`flexframe_sync.flex_sync_blocks_batched`:
    the MF + differential-template front-end vmaps over strided stream
    windows and every candidate decodes against its own block's
    ``z``/``metric``/``ext`` rows — bit-identical to a scan of
    :func:`gmsk_sync_block` on the DETECTED rows (detected/valid masks,
    t_start, payloads, carried state).  Undetected rows differ in the
    unmasked fields: the scan's per-block decode gate zeroes them for
    detection-free blocks while the fused batch decodes every row."""
    from .flexframe_sync import FlexResults
    blocks = iqfmt.iq_from_any(blocks)    # accepts [2, n_blocks, bs] planes
    n_blocks, bs = blocks.shape
    assert bs == sync.block_size
    K = sync.max_frames
    full = jnp.concatenate([state.tail, blocks.reshape(-1)])
    w_idx = (jnp.arange(n_blocks) * bs)[:, None] + \
        jnp.arange(sync.overlap + bs)[None, :]
    exts = full[w_idx]                              # [n_blocks, overlap+bs]

    z, metric, detected, locs = jax.vmap(
        lambda e: _front_end(sync, e))(exts)

    blk_of = jnp.repeat(jnp.arange(n_blocks), K)
    locs_f = locs.reshape(-1)
    (user, payload, plen, mod_f, f0, f1, check, hvalid, pvalid, rssi, evm,
     cfo) = _gated_decode(
        sync, z[blk_of], metric[blk_of], exts[blk_of], jnp.any(detected),
        locs_f, per_candidate_source=True)

    def rs(v):
        return v.reshape((n_blocks, K) + v.shape[1:])

    res = FlexResults(
        detected=detected,
        header_valid=detected & rs(hvalid),
        payload_valid=detected & rs(pvalid),
        header=rs(user), payload=rs(payload),
        payload_len=jnp.where(detected, rs(plen), 0),
        mod=rs(mod_f), fec0=rs(f0), fec1=rs(f1), check=rs(check),
        rssi=rs(rssi), evm=rs(evm), cfo=rs(cfo),
        t_start=(state.base + jnp.arange(n_blocks, dtype=jnp.int32)[:, None]
                 * bs + locs.astype(jnp.int32)),
    )
    new_state = GmskSyncState(
        tail=full[full.shape[0] - sync.overlap:],
        base=state.base + jnp.int32(n_blocks * bs))
    return new_state, res
