"""Tracing / profiling utilities.

The reference's only instrumentation is the tic/toc timer used for run
duration and throughput math (SURVEY.md §5).  The equivalents here:

* :func:`trace` — context manager around ``jax.profiler`` traces (view with
  TensorBoard / xprof),
* :class:`ThroughputMeter` — per-block samples/s counters with EMA, the
  streaming analog of the reference's end-of-run kbps math
  (/root/reference/src/ofdmflexframe_rx.cc:197-199).
"""
from __future__ import annotations

import contextlib
import time

__all__ = ["trace", "ThroughputMeter"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace for the enclosed block."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class ThroughputMeter:
    """Samples/s counter over streamed blocks (EMA + lifetime totals)."""

    def __init__(self, ema_alpha: float = 0.2):
        self.alpha = ema_alpha
        self.total_samples = 0
        self.total_time = 0.0
        self.ema_sps = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_samples: int):
        if self._t0 is None:
            raise RuntimeError("ThroughputMeter.stop() without start()")
        dt = time.perf_counter() - self._t0
        self.total_samples += n_samples
        self.total_time += dt
        sps = n_samples / max(dt, 1e-12)
        self.ema_sps = (sps if self.ema_sps == 0.0 else
                        self.alpha * sps + (1 - self.alpha) * self.ema_sps)
        return sps

    @property
    def mean_sps(self) -> float:
        return self.total_samples / max(self.total_time, 1e-12)
