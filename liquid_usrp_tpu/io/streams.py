"""IQ stream sources/sinks — the UHD replacement (SURVEY.md §2.4).

The reference moves complex-float32 samples to/from USRP hardware
(``uhd::io_type_t::COMPLEX_FLOAT32`` everywhere).  Here streams are files or
arrays with the same sample format:

* ``.iq`` / ``.dat`` / ``.cfile``: raw interleaved float32 I/Q (the de-facto
  SDR interchange format; also what the reference's octave dumps use),
* ``.sc16``: interleaved int16 I/Q (UHD's over-the-wire format; handled by
  the native engine when built, NumPy otherwise),
* ``.sc8``: interleaved int8 I/Q (UHD's reduced-rate sc8 wire mode;
  ±127 full scale — the on-device ingest twin is ``ops/iqfmt.py`` SC8
  planes),
* ``.npy``: NumPy complex64.

Block-oriented read/write mirrors the reference's 256-sample send buffers
and one-packet recv granularity (/root/reference/src/flexframe_tx.cc:197,
lib/ofdmtxrx.cc:560) — but with accelerator-friendly block sizes.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["write_iq", "read_iq", "iq_blocks"]


def write_iq(path: str, samples: np.ndarray) -> None:
    samples = np.asarray(samples, dtype=np.complex64)
    if path.endswith(".npy"):
        np.save(path, samples)
        return
    if path.endswith(".sc16"):
        inter = np.empty(samples.size * 2, dtype=np.float32)
        inter[0::2] = samples.real
        inter[1::2] = samples.imag
        np.clip(inter * 32767.0, -32768, 32767).astype(np.int16).tofile(path)
        return
    if path.endswith(".sc8"):
        inter = np.empty(samples.size * 2, dtype=np.float32)
        inter[0::2] = samples.real
        inter[1::2] = samples.imag
        np.clip(np.round(inter * 127.0), -127, 127).astype(np.int8) \
            .tofile(path)
        return
    inter = np.empty(samples.size * 2, dtype=np.float32)
    inter[0::2] = samples.real
    inter[1::2] = samples.imag
    inter.tofile(path)


def read_iq(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path).astype(np.complex64)
    if path.endswith(".sc16"):
        raw = np.fromfile(path, dtype=np.int16).astype(np.float32) / 32767.0
        if raw.size % 2:
            raw = raw[:-1]
        return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
    if path.endswith(".sc8"):
        raw = np.fromfile(path, dtype=np.int8).astype(np.float32) / 127.0
        if raw.size % 2:
            raw = raw[:-1]
        return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
    raw = np.fromfile(path, dtype=np.float32)
    if raw.size % 2:
        raw = raw[:-1]
    return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)


def iq_blocks(path: str, block_size: int):
    """Yield successive ``block_size`` chunks (zero-padded final block)."""
    data = read_iq(path)
    n = len(data)
    i = 0
    while i < n:
        blk = data[i:i + block_size]
        if len(blk) < block_size:
            blk = np.concatenate(
                [blk, np.zeros(block_size - len(blk), np.complex64)])
        yield blk
        i += block_size
