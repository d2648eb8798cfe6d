"""Streaming spectrogram + ASCII rendering (asgram semantics).

Capability parity: ``asgramcf_{create,set_scale,write,execute}`` driving the
ASCII FFT waterfall app (/root/reference/src/asgram_rx.cc:141-142,207,
213-224): sliding windowed FFT power in dB, quantized to a character ramp,
with peak value/frequency annotation.

Batched design: the sample ring buffer + one-FFT-per-poll of the reference
becomes a batched op — all requested FFT frames of a block are windowed and
transformed at once (``[n_frames, nfft]``); the ASCII quantization is a
host-side formatting step over the returned dB rows.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

__all__ = ["Spectrogram", "spectrogram_create", "spectrogram_block",
           "ascii_row"]


class Spectrogram(NamedTuple):
    nfft: int
    window: np.ndarray       # [nfft] float32 (NumPy: converted at trace)
    ref_level: float         # dB offset (reference's -65 dBm-ish default)
    scale: float             # dB per character


def spectrogram_create(nfft: int = 64, ref_level: float = -65.0,
                       scale: float = 5.0) -> Spectrogram:
    # Hamming window (smooth sidelobe floor for a 64-pt display FFT)
    w = np.hamming(nfft).astype(np.float32)
    return Spectrogram(nfft=nfft, window=w,
                       ref_level=ref_level, scale=scale)


def spectrogram_block(sg: Spectrogram, x: jnp.ndarray):
    """Compute dB spectra for every length-``nfft`` frame of ``x``.

    ``x``: ``[n_frames * nfft]`` -> ``psd_db [n_frames, nfft]`` (DC-centered),
    plus ``(peak_db[n_frames], peak_freq[n_frames])`` with frequency in
    cycles/sample in [-0.5, 0.5).
    """
    nfft = sg.nfft
    frames = x.reshape(-1, nfft) * jnp.asarray(sg.window).astype(x.dtype)
    spec = jnp.fft.fftshift(jnp.fft.fft(frames, axis=-1), axes=-1)
    psd = 20.0 * jnp.log10(jnp.maximum(jnp.abs(spec), 1e-12) /
                           jnp.sqrt(nfft))
    peak_idx = jnp.argmax(psd, axis=-1)
    peak_db = jnp.take_along_axis(psd, peak_idx[:, None], axis=-1)[:, 0]
    peak_freq = (peak_idx.astype(jnp.float32) - nfft // 2) / nfft
    return psd, peak_db, peak_freq


_ASCII_RAMP = " ._-+o*&$#"


def ascii_row(sg: Spectrogram, psd_db_row: np.ndarray) -> str:
    """Render one PSD row to the reference app's ASCII waterfall format."""
    q = (np.asarray(psd_db_row) - sg.ref_level) / sg.scale
    q = np.clip(q.astype(np.int64), 0, len(_ASCII_RAMP) - 1)
    return "".join(_ASCII_RAMP[i] for i in q)
