"""Device mesh construction for the SDR pipelines.

The reference is single-host with pthread workers (SURVEY.md §2.2); the
device-mesh scaling axes are:

* ``time``    — stream time-blocks with overlap-save halo exchange
  (the SP/CP analog of its streaming filter state),
* ``channel`` — the embarrassingly-parallel per-channel synchronizers
  (the TP/EP analog of the serial loop at
  /root/reference/lib/multichannelrx.cc:185-195).

Collectives ride the interconnect (NVLink within a host): ``ppermute`` for
halos, ``all_to_all`` for the channelizer->sync reshard,
``psum``/``all_gather`` for stats aggregation.
"""
from __future__ import annotations

import jax

__all__ = ["make_sdr_mesh", "factor_devices"]


def factor_devices(n: int) -> tuple[int, int]:
    """Split ``n`` devices into (time, channel) axes, preferring balance."""
    best = (n, 1)
    for t in range(1, n + 1):
        if n % t == 0:
            c = n // t
            if abs(t - c) < abs(best[0] - best[1]):
                best = (t, c)
    return best


def make_sdr_mesh(n_devices: int | None = None,
                  axis_shapes: tuple[int, int] | None = None) -> jax.sharding.Mesh:
    """Mesh with named axes ``('time', 'channel')``."""
    devices = jax.devices()
    n = n_devices if n_devices is not None else len(devices)
    if n > len(devices):
        raise ValueError(
            f"requested {n} devices but only {len(devices)} available")
    t, c = axis_shapes if axis_shapes is not None else factor_devices(n)
    if t * c != n:
        raise ValueError(f"axis shapes {t}x{c} != {n} devices")
    return jax.make_mesh((t, c), ("time", "channel"),
                         devices=devices[:n])
