"""Polyphase filterbank channelizer (analysis + synthesis).

Capability parity: ``firpfbch_crcf_create_kaiser(LIQUID_SYNTHESIZER|
LIQUID_ANALYZER, 2N, m, As)`` with ``_synthesizer_execute`` /
``_analyzer_execute`` (/root/reference/lib/multichanneltx.cc:85-87,213 and
lib/multichannelrx.cc:89-91,188).  The reference fires the channelizer once
per ``M = 2N`` samples inside a per-sample loop; here a whole IQ block is
processed in one shot.

Batched design: the critically-sampled DFT filterbank factors into
(1) a reshape of the stream into ``[n_frames, M]`` frames, (2) ``P`` fused
multiply-add taps along the frame axis per polyphase branch (the prototype
``h[qM+p]`` becomes a ``[P, M]`` coefficient array broadcast over frames) and
(3) a batched length-``M`` (I)FFT across branches.  All three map cleanly
onto fused elementwise work + XLA's native FFT; the carried state is the
last ``P-1`` frames so block boundaries are exact (overlap-save
invariance, tested).

Channel semantics: analysis output ``X_k[n]`` is the channel-``k`` (center
frequency ``k/M`` cycles/sample) baseband stream decimated by ``M``:

    X_k[n] = sum_m h[m] e^{+j 2pi k m / M} x[nM + M-1 - m]

and synthesis places ``Y_k[n]`` at frequency ``k/M``:

    y[nM + p] = sum_q g[qM + p] v_p[n - q],  v_p[n] = sum_k Y_k[n] e^{j2pi kp/M}
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .filter_design import pfb_channelizer_prototype

__all__ = [
    "Pfbch", "PfbchState", "pfbch_create", "pfbch_state",
    "pfb_analyze_block", "pfb_synthesize_block",
]


class Pfbch(NamedTuple):
    M: int                 # number of channels (= frames size)
    P: int                 # taps per polyphase branch (2*m)
    h_pol: np.ndarray      # [P, M] float32, h_pol[q, p] = h[q*M + p]
    # NOTE: NumPy on purpose — device constants are materialized at trace
    # time (an eagerly-created jnp closure constant breaks some backends)


class PfbchState(NamedTuple):
    frames: jnp.ndarray    # [P-1, M] complex64 carried input/output frames


def pfbch_create(num_channels: int, m: int = 7, As: float = 60.0) -> Pfbch:
    M = num_channels
    h = pfb_channelizer_prototype(M, m, As)          # length 2*M*m
    P = 2 * m
    h_pol = h.reshape(P, M).astype(np.float32)
    return Pfbch(M=M, P=P, h_pol=h_pol)


def pfbch_state(ch: Pfbch) -> PfbchState:
    return PfbchState(
        frames=jnp.zeros((ch.P - 1, ch.M), jnp.complex64))


def _branch_filter(ch: Pfbch, state_frames: jnp.ndarray,
                   frames: jnp.ndarray) -> jnp.ndarray:
    """Per-branch FIR along the frame axis: ``u[n,p] = sum_q hq[p] f[n-q,p]``."""
    ext = jnp.concatenate([state_frames, frames], axis=0)  # [P-1+n, M]
    n = frames.shape[0]
    h = jnp.asarray(ch.h_pol)
    u = jnp.zeros_like(frames)
    for q in range(ch.P):  # P is small (14-26): unrolled FMA chain, XLA-fused
        u = u + h[q][None, :].astype(frames.dtype) * \
            ext[ch.P - 1 - q: ch.P - 1 - q + n]
    return u


def pfb_analyze_block(ch: Pfbch, state: PfbchState, x: jnp.ndarray):
    """Analyze ``x[n_frames*M]`` -> ``(state', X[n_frames, M])`` channels."""
    M = ch.M
    n = x.shape[-1] // M
    frames = x.reshape(n, M)
    rev = frames[:, ::-1]                     # rev[n, p] = x[nM + M-1-p]
    u = _branch_filter(ch, state.frames, rev)
    X = M * jnp.fft.ifft(u, axis=-1).astype(jnp.complex64)
    return PfbchState(frames=jnp.concatenate(
        [state.frames, rev], axis=0)[-(ch.P - 1):]), X


def pfb_synthesize_block(ch: Pfbch, state: PfbchState, Y: jnp.ndarray):
    """Synthesize channel frames ``Y[n_frames, M]`` -> ``(state', y[n*M])``."""
    M = ch.M
    v = M * jnp.fft.ifft(Y, axis=-1).astype(jnp.complex64)  # v[n, p]
    out = _branch_filter(ch, state.frames, v)
    y = out.reshape(-1)
    return PfbchState(frames=jnp.concatenate(
        [state.frames, v], axis=0)[-(ch.P - 1):]), y
