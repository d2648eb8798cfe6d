"""Automatic gain control with settable loop bandwidth.

Capability parity: ``agc_crcf_{create,set_bandwidth,execute,
get_signal_level,get_rssi}`` as used by the receive-power meter app
(/root/reference/src/rssi.cc:115-116,187-190,202).

Block design: the AGC loop is a first-order IIR on the instantaneous
power estimate — a linear recurrence, so a whole block is processed with one
associative-scan (``lax.associative_scan``) instead of a per-sample loop.
Returns the gain-corrected block plus per-sample signal level / RSSI so
callers can log at any decimation.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["AgcState", "agc_init", "agc_block"]


class AgcState(NamedTuple):
    level: jnp.ndarray   # scalar float32: smoothed input signal level (linear)
    alpha: jnp.ndarray   # scalar float32: loop smoothing factor (~bandwidth)


def agc_init(bandwidth: float = 0.01, initial_level: float = 1.0) -> AgcState:
    return AgcState(level=jnp.float32(initial_level),
                    alpha=jnp.float32(bandwidth))


def agc_block(state: AgcState, x: jnp.ndarray):
    """Track and normalize a block.

    Returns ``(state', y, level[N], rssi_db[N])`` where ``y = x / level`` is
    the unity-target output and ``rssi_db = 20 log10(level)``.
    """
    a = state.alpha
    # level recurrence: L[n] = (1-a) L[n-1] + a * |x[n]|  (amplitude dmn)
    amp = jnp.maximum(jnp.abs(x), 1e-10)

    def combine(c1, c2):
        # each element is (m, b) representing L -> m*L + b
        m1, b1 = c1
        m2, b2 = c2
        return m1 * m2, m2 * b1 + b2

    n = x.shape[-1]
    ms = jnp.full((n,), 1.0 - a)
    bs = a * amp
    m_acc, b_acc = jax.lax.associative_scan(combine, (ms, bs))
    level = m_acc * state.level + b_acc
    y = x / jnp.maximum(level, 1e-12).astype(x.dtype)
    rssi = 20.0 * jnp.log10(jnp.maximum(level, 1e-12))
    return state._replace(level=level[-1]), y, level, rssi
