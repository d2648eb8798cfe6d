"""Bit/byte manipulation substrate for GF(2)-linear coding kernels.

Everything in the coding layer (CRC, Hamming, Golay, conv codes) is GF(2)
arithmetic.  On an accelerator the profitable formulation is
bits-as-small-ints and GF(2) matrix products as matmuls reduced mod 2 —
dense batched work instead of the bit-twiddling loops the reference's
dependency (liquid-dsp) uses on CPU.

Conventions
-----------
* A "byte array" is uint8 ``[n]``.
* A "bit array" is uint8 ``[n*8]`` of 0/1 values, MSB-first within each byte
  (matching the on-air ordering used by the framing layer).
* GF(2) matmul helpers accept int-typed arrays and reduce mod 2; for large
  operands they promote to float32 so XLA can hand them to its matmul
  libraries.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = [
    "unpack_bits",
    "pack_bits",
    "gf2_matmul",
    "np_unpack_bits",
    "np_pack_bits",
]


def unpack_bits(data: jnp.ndarray) -> jnp.ndarray:
    """uint8 bytes ``[..., n]`` -> bits ``[..., n*8]``, MSB first."""
    data = data.astype(jnp.uint8)
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bits = (data[..., :, None] >> shifts) & jnp.uint8(1)
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """bits ``[..., n*8]`` (0/1) -> uint8 bytes ``[..., n]``, MSB first."""
    n = bits.shape[-1] // 8
    b = bits.reshape(*bits.shape[:-1], n, 8).astype(jnp.uint8)
    weights = (jnp.uint8(1) << jnp.arange(7, -1, -1, dtype=jnp.uint8))
    return jnp.sum(b * weights, axis=-1, dtype=jnp.uint8)


def gf2_matmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """GF(2) matrix product ``(a @ b) % 2`` computed as a float32 matmul.

    ``a``: ``[..., k]`` bits, ``b``: ``[k, n]`` bits.  float32 accumulation
    of 0/1 values is exact for ``k < 2^24`` (far above the largest CRC basis
    contraction, 65536), and unlike an integer dot it maps onto the tensor
    cores.

    Exact at DEFAULT precision, also where a GPU runs the product in TF32:
    TF32 rounds each operand to a 10-bit mantissa, which holds 0 and 1
    exactly, and the accumulation stays float32, so every partial sum is an
    integer below 2^24.
    """
    acc = jnp.matmul(a.astype(jnp.float32), b.astype(jnp.float32),
                     preferred_element_type=jnp.float32)
    return (acc.astype(jnp.int32) & 1).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# NumPy (host / design-time) versions — used to precompute code tables.
# ---------------------------------------------------------------------------

def np_unpack_bits(data: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.asarray(data, dtype=np.uint8), axis=-1)


def np_pack_bits(bits: np.ndarray) -> np.ndarray:
    return np.packbits(np.asarray(bits, dtype=np.uint8), axis=-1)
