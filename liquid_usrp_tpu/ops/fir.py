"""Streaming FIR kernels: overlap-save block filtering, interp, decim.

Capability parity: liquid-dsp's ``firfilt``/``firinterp``/``firdecim`` object
surface as used by the reference (matched-filter interpolator at
/root/reference/src/narrowband_tx.cc:157,197; every framegen/framesync
internally is FIR-based).

Block design: the reference filters one sample per call through a
delay line; here each operator is a pure ``step(state, block) -> (state',
out)`` over a whole IQ block.  The carried state is exactly the filter memory
(last ``L-1`` inputs), so results are bit-identical regardless of block size
(overlap-save invariance — tested).  Convolutions are expressed with
``jnp.convolve`` / strided reshapes, which XLA lowers to fused convolutions;
polyphase structure (interp) turns the upsample-then-filter pattern into a
dense per-phase matmul with zero wasted MACs.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "FirState", "fir_init", "firinterp_init", "fir_block",
    "firinterp_block", "firdecim_block",
]


class FirState(NamedTuple):
    tail: jnp.ndarray  # last (L-1) inputs, complex64 [L-1]


def fir_init(ntaps: int, dtype=jnp.complex64) -> FirState:
    return FirState(tail=jnp.zeros((ntaps - 1,), dtype))


def firinterp_init(ntaps: int, k: int, dtype=jnp.complex64) -> FirState:
    P = -(-ntaps // k)  # taps per polyphase branch
    return FirState(tail=jnp.zeros((P - 1,), dtype))


def _conv_valid(x: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    """``y[n] = sum_t h[t] x[n + L - 1 - t]`` for a pre-extended ``x``."""
    if jnp.iscomplexobj(x) and not jnp.iscomplexobj(h):
        h = h.astype(x.dtype)
    return jnp.convolve(x, h, mode="valid")


def fir_block(taps: jnp.ndarray, state: FirState, x: jnp.ndarray):
    """Causal FIR over a block: ``y[n] = sum_t h[t] x[n - t]``.

    ``x``: ``[N]``; returns ``(state', y[N])``.
    """
    ext = jnp.concatenate([state.tail, x])
    y = _conv_valid(ext, taps)
    ntaps = taps.shape[0]
    return FirState(tail=ext[ext.shape[0] - (ntaps - 1):]), y


def firinterp_block(taps: jnp.ndarray, k: int, state: FirState,
                    x: jnp.ndarray):
    """Polyphase k-fold interpolating FIR: ``[N] -> [N*k]``.

    ``y[n*k + p] = sum_m h[p + k*m] x[n - m]`` — each phase is an independent
    dense FIR over the undecimated input (no multiply-by-zero work).
    The carried state stores ``P-1`` input samples where ``P = ceil(L/k)``.
    """
    L = taps.shape[0]
    P = -(-L // k)
    hp = jnp.concatenate([taps, jnp.zeros(P * k - L, dtype=taps.dtype)])
    phases = hp.reshape(P, k)  # phases[:, p] = h[p::k]
    ext = jnp.concatenate([state.tail, x])  # [P-1 + N]
    n = x.shape[-1]
    # windows[i, m] = x[i - m] = ext[i + P - 1 - m]
    idx = (jnp.arange(n)[:, None] + (P - 1) - jnp.arange(P)[None, :])
    windows = ext[idx]  # [N, P]
    # HIGHEST: a float32 matmul may otherwise run in TF32 (~3 decimal
    # digits) on a GPU, well above the filters' stopband floor
    y = jnp.matmul(windows, phases.astype(ext.dtype),
                   precision=jax.lax.Precision.HIGHEST)  # [N, k]
    return FirState(tail=ext[ext.shape[0] - (P - 1):]), y.reshape(n * k)


def firdecim_block(taps: jnp.ndarray, k: int, state: FirState,
                   x: jnp.ndarray):
    """k-fold decimating FIR: ``[N] -> [N//k]`` (N must be a multiple of k).

    ``y[n] = sum_t h[t] x[n*k + k - 1 - t]`` (newest-sample aligned, matching
    a sample-serial decimator that emits on every k-th input).
    """
    ext = jnp.concatenate([state.tail, x])
    full = _conv_valid(ext, taps)          # full[n] = sum h[t] x[n - t]
    y = full[k - 1::k]
    ntaps = taps.shape[0]
    return FirState(tail=ext[ext.shape[0] - (ntaps - 1):]), y
