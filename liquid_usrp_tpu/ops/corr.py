"""Streamwise correlation primitives for the frame detectors.

The synchronizer front-ends correlate the incoming IQ stream against
known templates at every sample offset, with template taps spaced ``k``
samples apart (symbol rate).  Two exact formulations, picked by
measurement per site:

* **FFT-domain chains** for the matched filters and <=2-channel template
  correlations: one forward FFT of the stream is shared by every stage
  (MF and template correlations compose by multiplying their
  host-precomputed frequency responses).  3-6x the throughput of
  time-domain ``jnp.convolve``/``lax.conv`` on the host backend.
* **Reshape-cumsum comb moving sums** for ones-kernel energy terms:
  ``y[n] = sum_{d<D} x[n + k d]`` is a per-residue moving sum on the
  ``[L/k, k]`` reshape — O(L), no transform, exact.

The many-channel segmented correlation (GMSK's 8-segment metric) stays a
dilated ``lax.conv`` at its call site: per-channel inverse FFTs would
cost more than the conv there.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ["next_pow2", "comb_rev_freq_np", "comb_moving_sum",
           "sliding_max"]


def next_pow2(n: int) -> int:
    return 1 << int(np.ceil(np.log2(max(n, 2))))


def comb_rev_freq_np(kern: np.ndarray, k: int, nfft: int) -> np.ndarray:
    """Frequency response (host numpy) of the time-reversed k-dilated comb
    of ``kern`` — correlation as convolution.

    With ``Y = ifft(fft(x, nfft) * comb_rev_freq_np(kern, k, nfft))`` the
    linear correlation ``sum_d kern[d] x[n + k d]`` is ``Y[n + span - 1]``,
    ``span = (len(kern) - 1) k + 1`` (valid while every composed kernel's
    span plus the signal length stays below ``nfft``).
    """
    comb = np.zeros(((len(kern) - 1) * k + 1,), np.complex64)
    comb[::k] = kern
    return np.fft.fft(comb[::-1], nfft).astype(np.complex64)


def comb_moving_sum(x: jnp.ndarray, D: int, k: int,
                    n_out: int) -> jnp.ndarray:
    """``y[n] = sum_{d<D} x[n + k d]`` for ``n in [0, n_out)`` (real x)."""
    L = x.shape[0]
    M = -(-L // k) + D + 1
    xp = jnp.concatenate([x, jnp.zeros((M * k - L,), x.dtype)])
    X = xp.reshape(M, k)
    cs = jnp.concatenate([jnp.zeros((1, k), x.dtype),
                          jnp.cumsum(X, axis=0)])
    S = cs[D:] - cs[:-D]                 # S[m, r] = sum_d X[m + d, r]
    return S.reshape(-1)[:n_out]


def sliding_max(x: jnp.ndarray, radius: int) -> jnp.ndarray:
    """``out[i] = max(x[i-radius : i+radius+1])`` ("SAME", -inf padded).

    One ``lax.reduce_window``.  The O(1)-per-sample van Herk / Gil-Werman
    form (two per-block running maxima) lost to it on both backends the
    detectors run on: at the flagship NMS shape (8 rows x 65633 samples,
    radius 48) van Herk took 0.133 ms and reduce_window 0.127 ms on an
    NVIDIA H100 80GB HBM3 at a 700 W power limit; on XLA:CPU the
    composed noise-path step took 4.66 vs 3.22 ms per 32k block.
    """
    from jax import lax
    return lax.reduce_window(x, -jnp.inf, lax.max, (2 * radius + 1,), (1,),
                             "SAME")
