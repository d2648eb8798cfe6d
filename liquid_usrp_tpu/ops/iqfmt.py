"""Reduced-precision IQ ingest formats.

The RX pipelines do a few FLOPs per byte of input, so the device-memory
format of the mixture stream is a throughput lever.  Three ingest formats,
by input HBM bytes per sample:

* complex64 — 8 B/sample, the reference's host format
  (``uhd::io_type_t::COMPLEX_FLOAT32``, /root/reference/lib/ofdmtxrx.cc:96).
* bfloat16 I/Q planes — 4 B/sample, ~45 dB quantization-SNR floor; also
  int16 planes at the same width (UHD's default SC16 over-the-wire codes,
  dequantized on-device at the ±32767 ↔ ±1.0 wire convention).
* int8 I/Q planes ("SC8") — 2 B/sample, the analog of UHD's sc8
  over-the-wire mode (used on bandwidth-limited links); ±127 ↔ ±1.0
  full-scale ADC convention, ~40 dB quantization SNR for an AGC-normalized
  stream — still far above the channel SNR the decode chain operates at.

Convention: a "planes" array is real-valued ``[2, L]`` (row 0 = I,
row 1 = Q) in bfloat16/float16/float32 (already-scaled values) or
int8/int16 (full-scale wire codes).  Pipeline steps accept either a
complex64 stream or a planes array; planes are combined to complex64 at
trace time so every downstream kernel is unchanged — only the HBM-side
representation (and hence the input bandwidth) differs.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["iq_to_planes", "iq_to_planes_sc8", "iq_from_any",
           "SC8_FULL_SCALE", "SC16_FULL_SCALE"]

SC8_FULL_SCALE = 127.0      # symmetric: -128 never emitted by the quantizer
SC16_FULL_SCALE = 32767.0   # matches io/streams.py .sc16 files + UHD OTW


def iq_to_planes(x: jnp.ndarray, dtype=jnp.bfloat16) -> jnp.ndarray:
    """Complex stream ``[...]`` -> real planes ``[2, ...]`` (rounded)."""
    return jnp.stack([x.real, x.imag]).astype(dtype)


def iq_to_planes_sc8(x: jnp.ndarray) -> jnp.ndarray:
    """Complex stream -> int8 wire-code planes ``[2, ...]``.

    The caller is the AGC: the stream must already be normalized so
    ``|I|,|Q| <= 1.0`` (full scale); values are rounded to ±127 codes the
    way an 8-bit ADC / UHD's sc8 OTW mode would.  Out-of-range samples
    clip (exactly the radio behavior).
    """
    planes = jnp.stack([x.real, x.imag]) * SC8_FULL_SCALE
    return jnp.clip(jnp.round(planes), -127.0, 127.0).astype(jnp.int8)


def iq_from_any(x: jnp.ndarray) -> jnp.ndarray:
    """Accept a complex stream or ``[2, ...]`` real planes; return
    complex64.  Trace-time dispatch on dtype: jit retraces per input
    signature, so every form shares one step function.

    Integer planes are treated as full-scale wire codes: int8 dequantizes
    at ±127 ↔ ±1.0 (SC8), int16 at ±32767 ↔ ±1.0 (SC16, same convention
    as ``io/streams.py`` and the native engine's file converters)."""
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        return x.astype(jnp.complex64)
    if x.ndim < 2 or x.shape[0] != 2:
        raise ValueError(
            f"planes input must be [2, ...] real (got {x.shape} {x.dtype})")
    if x.dtype == jnp.int8:
        xf = x.astype(jnp.float32) * (1.0 / SC8_FULL_SCALE)
    elif x.dtype == jnp.int16:
        xf = x.astype(jnp.float32) * (1.0 / SC16_FULL_SCALE)
    elif jnp.issubdtype(x.dtype, jnp.floating):
        xf = x.astype(jnp.float32)
    else:
        # other integer widths have no wire convention here; a silent
        # cast would break every downstream threshold
        raise ValueError(
            f"planes must be bf16/f16/f32 (scaled) or int8/int16 (wire "
            f"codes), got {x.dtype}")
    return jax.lax.complex(xf[0], xf[1])
