"""Resamplers: half-band 2x, arbitrary polyphase, and multi-stage.

Capability parity with the reference's resampling surface:

* ``resamp2_crcf`` half-band interp/decim (/root/reference/src/
  gmskframe_tx.cc:160,229 and src/gmskframe_rx.cc:176,246-247),
* ``resamp_crcf`` single-stage arbitrary polyphase resampler, 64-filter bank
  (/root/reference/src/gmskframe_tx.cc:156-157,236),
* ``msresamp_crcf`` multi-stage arbitrary resampler, 60 dB stopband
  (/root/reference/src/flexframe_tx.cc:170,237 et al.).

Static-shape design.  The reference steps a phase accumulator one sample at a
time; variable output counts per call (``nw``, /root/reference/src/
flexframe_rx.cc:239-243) are the blocker for static-shape compilation
(SURVEY.md §7 hard part 3).  Here the arbitrary resampler materializes the
whole **output timing grid** of a block in one shot using *exact integer
timing*: the rate is snapped to a rational ``q/p`` (output:input), the
per-output input index and fractional phase are integer expressions in the
output slot index, and every output is a gathered input window dotted with a
(linearly interpolated) polyphase filter — one batched gather + weighted
reduction per block.  Output blocks have a static ``max_out`` with a validity
mask plus count; the carried state (delay-line tail + integer timing
numerator) makes results block-size invariant.

``msresamp`` composes deterministic half-band stages with a final arbitrary
stage in ``(0.5, 1]``, so only the last stage produces masked output.
"""
from __future__ import annotations

from fractions import Fraction
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .filter_design import firdes_kaiser, halfband_kaiser
from .fir import FirState, fir_init, fir_block, firinterp_block, \
    firinterp_init

__all__ = [
    "Resamp2", "resamp2_create", "resamp2_interp_block", "resamp2_decim_block",
    "Resamp", "ResampState", "resamp_create", "resamp_block",
    "resamp_set_rate", "resamp_rescale_state",
    "Msresamp", "MsresampState", "msresamp_create", "msresamp_block",
    "compact_masked",
]


# ---------------------------------------------------------------------------
# half-band 2x (resamp2 semantics)
# ---------------------------------------------------------------------------

class Resamp2(NamedTuple):
    taps: np.ndarray   # [4m+1] float32 half-band (NumPy: converted at trace)


def resamp2_create(m: int = 7, As: float = 60.0) -> Resamp2:
    return Resamp2(taps=halfband_kaiser(m, As).astype(np.float32))


def resamp2_state(r2: Resamp2) -> FirState:
    return firinterp_init(r2.taps.shape[0], 2)


def resamp2_decim_state(r2: Resamp2) -> FirState:
    return fir_init(r2.taps.shape[0])


def resamp2_interp_block(r2: Resamp2, state: FirState, x: jnp.ndarray):
    """2x interpolation: ``[N] -> [2N]`` (unit passband gain)."""
    state, y = firinterp_block(jnp.asarray(r2.taps) * 2.0, 2, state, x)
    return state, y


def resamp2_decim_block(r2: Resamp2, state: FirState, x: jnp.ndarray):
    """2x decimation: ``[N] -> [N/2]`` (N even).

    Uses decimation phase 0 (``y[n] = filtered[2n]``) so that an interp ->
    decim cascade has integer group delay (2m+... samples), not a
    half-sample offset.
    """
    state, full = fir_block(jnp.asarray(r2.taps), state, x)
    return state, full[::2]


# ---------------------------------------------------------------------------
# arbitrary polyphase resampler (resamp semantics)
# ---------------------------------------------------------------------------

class Resamp(NamedTuple):
    pfb: np.ndarray       # [npfb + 1, P] float32 (extra row for lerp wrap)
    npfb: int
    P: int                # taps per phase
    # exact rational timing: input advances p_num/q_den per output sample
    a: int                # integer part of the per-output input stride
    b: int                # fractional numerator (stride = a + b/q)
    q: int                # denominator
    rate: float           # output/input rate (approximated)


class ResampState(NamedTuple):
    tail: jnp.ndarray     # [P-1] complex64 input delay line
    i0: jnp.ndarray       # int32: input index of next output (vs block start)
    num0: jnp.ndarray     # int32: fractional numerator in [0, q)


def resamp_create(rate: float, m: int = 7, fc: float = 0.45,
                  As: float = 60.0, npfb: int = 64,
                  max_den: int = 4096) -> Resamp:
    """Arbitrary-rate polyphase resampler.

    ``rate``: output/input ratio (snapped to a rational with denominator
    <= ``max_den``); ``m``: filter semi-length (P = 2m+1 taps per phase);
    ``fc``: cutoff relative to the narrower Nyquist band.
    """
    P = 2 * m + 1
    L = npfb * P
    cutoff = fc * min(1.0, rate) / npfb
    proto = firdes_kaiser(L, cutoff, As)
    # normalize so each phase sums to ~1 (unit passband gain)
    proto = proto / np.sum(proto) * npfb
    pfb = proto.reshape(P, npfb).T  # pfb[phase, tap] = proto[phase + npfb*tap]
    # lerp wrap row = the phase->npfb limit, i.e. the phase-0 subfilter
    # ADVANCED one tap (proto[npfb*(tap+1)]); using the unshifted row 0
    # here puts a full-sample delay discontinuity at frac ~= 1
    wrap = np.concatenate([pfb[0, 1:], [0.0]])
    pfb = np.concatenate([pfb, wrap[None, :]], axis=0)
    frac = Fraction(rate).limit_denominator(max_den)
    # input stride per output = 1/rate = q/p as a fraction
    stride = Fraction(frac.denominator, frac.numerator)
    a, b, q = (stride.numerator // stride.denominator,
               stride.numerator % stride.denominator, stride.denominator)
    return Resamp(pfb=pfb.astype(np.float32), npfb=npfb, P=P,
                  a=a, b=b, q=q, rate=float(frac))


def resamp_state(rs: Resamp) -> ResampState:
    return ResampState(tail=jnp.zeros((rs.P - 1,), jnp.complex64),
                       i0=jnp.int32(0), num0=jnp.int32(0))


def resamp_set_rate(rs: Resamp, rate: float,
                    max_den: int = 4096) -> Resamp:
    """Runtime rate mutation (``resamp_crcf_set_rate`` parity,
    /root/reference/src/gmskframe_tx.cc:157, src/gmskframe_rx.cc:173).

    Like the reference, only the timing changes — the polyphase filter bank
    is kept (liquid does not redesign the filter on set_rate either), so
    this is cheap; the carried delay line stays valid.  Re-jit happens per
    distinct rate, the host-side analog of the reference's internal state
    update.  Use :func:`resamp_rescale_state` to carry streaming state
    across the change.
    """
    frac = Fraction(rate).limit_denominator(max_den)
    stride = Fraction(frac.denominator, frac.numerator)
    a, b, q = (stride.numerator // stride.denominator,
               stride.numerator % stride.denominator, stride.denominator)
    return rs._replace(a=a, b=b, q=q, rate=float(frac))


def resamp_rescale_state(rs_old: Resamp, rs_new: Resamp,
                         state: ResampState) -> ResampState:
    """Carry streaming state across :func:`resamp_set_rate`: the delay line
    transfers directly; the fractional timing numerator is re-expressed on
    the new denominator grid (nearest exact phase)."""
    num = jnp.round(state.num0.astype(jnp.float32) *
                    (rs_new.q / rs_old.q)).astype(jnp.int32)
    return state._replace(num0=jnp.clip(num, 0, rs_new.q - 1))


def resamp_max_out(rs: Resamp, n_in: int) -> int:
    return int(np.ceil(n_in * rs.rate)) + 2


def resamp_block(rs: Resamp, state: ResampState, x: jnp.ndarray):
    """Resample a block: ``[N] -> (state', y[max_out], valid[max_out], count)``.

    Output slot ``j`` samples the input at exact time
    ``t_j = i0 + j*a + (num0 + j*b)/q`` (input-sample units); its value is the
    input window at ``floor(t_j)`` dotted with the polyphase filter at the
    fractional phase, linearly interpolated between adjacent phase filters.

    One ``[max_out, P]`` window gather for any rate.  A gather-free form
    (one strided convolution per phase class, for small stride
    denominators) lost to it on both backends: through the app chain's
    msresamp on 16384-sample blocks it took 0.283 vs 0.133 ms at rate 1.5
    and 0.209 vs 0.195 ms at rate 2.0 on an NVIDIA H100 80GB HBM3 at a
    700 W power limit, and ran 3-4x slower on XLA:CPU.
    """
    n = x.shape[-1]
    max_out = resamp_max_out(rs, n)
    if max_out * rs.b + rs.q >= 2 ** 31:
        raise ValueError(
            f"int32 timing overflow: block of {n} with rate "
            f"{rs.rate} (b={rs.b}, q={rs.q}); use smaller blocks or a "
            "coarser rational rate")
    ext = jnp.concatenate([state.tail, x])          # [P-1 + N]

    j = jnp.arange(max_out, dtype=jnp.int32)
    num = state.num0 + j * rs.b                     # < q + max_out*b, int32-safe
    i = state.i0 + j * rs.a + num // rs.q           # input index of output j
    frac = (num % rs.q).astype(jnp.float32) / rs.q  # [0, 1)
    valid = i < n

    i_safe = jnp.minimum(i, n - 1)
    # window for output j: x[i - P + 1 .. i] = ext[i .. i + P - 1],
    # REVERSED so tap q multiplies x[i - q] — convolution orientation.
    # (Ascending pairing is correlation: the fractional phase enters
    # with inverted sign and output timing sawtooths by ~2 samples at
    # the phase-wrap rate — a ~-23 dB reconstruction floor.)
    win_idx = i_safe[:, None] + jnp.arange(rs.P)[None, :]
    windows = ext[win_idx][:, ::-1]                 # [max_out, P]

    ph = frac * rs.npfb
    ph_lo = jnp.floor(ph).astype(jnp.int32)
    w = (ph - ph_lo)[:, None]
    pfb = jnp.asarray(rs.pfb)
    h = pfb[ph_lo] * (1.0 - w) + pfb[ph_lo + 1] * w  # [max_out, P]
    y = jnp.sum(windows * h.astype(ext.dtype), axis=-1)
    y = jnp.where(valid, y, 0.0)

    count = jnp.sum(valid.astype(jnp.int32))
    # state at the first invalid slot
    num_c = state.num0 + count * rs.b
    i_next = state.i0 + count * rs.a + num_c // rs.q
    new_state = ResampState(
        tail=ext[ext.shape[0] - (rs.P - 1):],
        i0=(i_next - n).astype(jnp.int32),
        num0=(num_c % rs.q).astype(jnp.int32),
    )
    return new_state, y, valid, count


# ---------------------------------------------------------------------------
# multi-stage resampler (msresamp semantics)
# ---------------------------------------------------------------------------

class Msresamp(NamedTuple):
    num_halfband: int     # half-band stages (decim if rate<1, interp if >1)
    is_interp: bool
    hb: Resamp2
    arb: Resamp


class MsresampState(NamedTuple):
    hb_states: tuple      # FirState per half-band stage
    arb_state: ResampState


def msresamp_create(rate: float, As: float = 60.0) -> Msresamp:
    """Multi-stage arbitrary resampler: half-band stages + one arbitrary
    stage with per-stage rate in (0.5, 1] (matching msresamp_crcf semantics:
    arbitrary total rate, ``As`` dB stopband)."""
    if rate <= 0:
        raise ValueError("rate must be positive")
    s = 0
    if rate < 1.0:
        r = rate
        while r <= 0.5:
            r *= 2.0
            s += 1
        return Msresamp(s, False, resamp2_create(7, As),
                        resamp_create(r, 7, 0.45, As))
    r = rate
    while r > 2.0:
        r /= 2.0
        s += 1
    # arb stage in (0.5, 1], then s or s+1 interp stages
    if r > 1.0:
        r /= 2.0
        s += 1
    return Msresamp(s, True, resamp2_create(7, As),
                    resamp_create(r, 7, 0.45, As))


def msresamp_state(ms: Msresamp) -> MsresampState:
    mk = resamp2_decim_state if not ms.is_interp else resamp2_state
    return MsresampState(
        hb_states=tuple(mk(ms.hb) for _ in range(ms.num_halfband)),
        arb_state=resamp_state(ms.arb),
    )


def msresamp_max_out(ms: Msresamp, n_in: int) -> int:
    if ms.is_interp:
        n = n_in * (2 ** ms.num_halfband)
    else:
        n = n_in // (2 ** ms.num_halfband)
    return resamp_max_out(ms.arb, n)


def msresamp_block(ms: Msresamp, state: MsresampState, x: jnp.ndarray):
    """``[N] -> (state', y[max_out], valid, count)``.

    For decimation N must be divisible by ``2**num_halfband``.

    Stage order note: liquid runs the arbitrary stage at the LOW-rate end
    (before the interpolators) to save compute.  Here the arbitrary stage
    always runs LAST on purpose: its output length is data-dependent
    (masked static-shape slots), and feeding a masked tail into streaming
    half-band stages would poison their carried filter state with padding
    zeros — the fixed-rate stages must see the gapless stream.  The extra
    arb-stage work at the high rate is the price of exact block-size
    invariance under XLA static shapes (SURVEY hard part 3).
    """
    hb_states = []
    cur = x
    for st in state.hb_states:
        if ms.is_interp:
            st, cur = resamp2_interp_block(ms.hb, st, cur)
        else:
            st, cur = resamp2_decim_block(ms.hb, st, cur)
        hb_states.append(st)
    arb_state, y, valid, count = resamp_block(ms.arb, state.arb_state, cur)
    return (MsresampState(tuple(hb_states), arb_state), y, valid, count)


def compact_masked(y: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Move valid samples to the front (stable), zero-fill the rest.

    With this resampler's monotone validity (all valid slots precede invalid
    ones) this is the identity, but downstream consumers use it defensively
    when fusing multiple masked blocks.
    """
    idx = jnp.cumsum(valid.astype(jnp.int32)) - 1
    out = jnp.zeros_like(y)
    out = out.at[jnp.where(valid, idx, y.shape[0] - 1)].add(
        jnp.where(valid, y, 0))
    return out
