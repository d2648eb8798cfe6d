"""Synthetic channel impairments for loopback testing.

The reference has no channel model — its "test" is over-the-air loopback with
real noise (SURVEY.md §4).  This framework replaces the air with a
deterministic impairment chain (AWGN, carrier-frequency offset, phase, delay,
gain, optional multipath), so every loopback test is reproducible and BER/PER
curves can be swept at exact SNRs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = ["Channel", "channel_apply", "awgn", "snr_to_noise_std"]


class Channel(NamedTuple):
    snr_db: float = 100.0        # AWGN SNR relative to unit signal power
    cfo: float = 0.0             # carrier offset, radians/sample
    phase: float = 0.0           # static phase, radians
    delay: int = 0               # integer sample delay (prepended zeros)
    gain: float = 1.0            # linear amplitude gain
    multipath: Optional[tuple] = None  # complex tap tuple, tap0 = LOS
    sro_ppm: float = 0.0         # sample-rate offset (clock skew), ppm


def snr_to_noise_std(snr_db: float, signal_power: float = 1.0) -> float:
    return float((signal_power * 10.0 ** (-snr_db / 10.0)) ** 0.5)


def awgn(key: jax.Array, x: jnp.ndarray, snr_db: float,
         signal_power: float = 1.0) -> jnp.ndarray:
    std = snr_to_noise_std(snr_db, signal_power)
    kr, ki = jax.random.split(key)
    noise = (jax.random.normal(kr, x.shape) +
             1j * jax.random.normal(ki, x.shape)) * (std / (2.0 ** 0.5))
    return x + noise.astype(x.dtype)


def channel_apply(ch: Channel, key: jax.Array, x: jnp.ndarray,
                  signal_power: float = 1.0) -> jnp.ndarray:
    """Apply gain -> multipath -> delay -> CFO/phase -> AWGN to a block."""
    y = x * ch.gain
    if ch.sro_ppm != 0.0:
        from ..ops import resamp as resamp_mod
        # max_den bounded so resamp_block's int32 timing stays safe at
        # ordinary block sizes (10**6 denominators overflowed the guard
        # past ~2k samples); the <=3e-10/sample rate rounding drifts
        # under 1e-3 samples over a million-sample stream — far below
        # the ppm-scale effect being modeled
        rs = resamp_mod.resamp_create(1.0 + ch.sro_ppm * 1e-6,
                                      max_den=1 << 15)
        st = resamp_mod.resamp_state(rs)
        st, out, valid, count = resamp_mod.resamp_block(rs, st, y)
        y = out  # trailing invalid slots are zeros (harmless tail)
    if ch.multipath is not None:
        taps = jnp.asarray(ch.multipath, dtype=jnp.complex64)
        y = jnp.convolve(y, taps, mode="full")[: y.shape[-1]]
    if ch.delay:
        y = jnp.concatenate([jnp.zeros((ch.delay,), dtype=y.dtype), y])
    if ch.cfo != 0.0 or ch.phase != 0.0:
        n = jnp.arange(y.shape[-1], dtype=jnp.float32)
        y = y * jnp.exp(1j * (ch.phase + ch.cfo * n)).astype(y.dtype)
    if ch.snr_db < 100.0:
        y = awgn(key, y, ch.snr_db,
                 signal_power * float(ch.gain) ** 2)
    return y
