"""Fixed-size sliding sample logs (windowcf/windowf semantics).

Capability parity: ``windowcf_{create,push,write,read}`` ring logs used for
IQ/RSSI capture dumps (/root/reference/src/rssi.cc:119-120,184-190,225-226
and src/asgram_rx.cc:134,210,244).

Functional design: a ring buffer as a pure pytree — block ``push`` is a
roll + dynamic-update-slice; ``read`` returns the contiguous time-ordered
view.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


__all__ = ["RingLog", "ring_init", "ring_push", "ring_read", "ring_valid"]


class RingLog(NamedTuple):
    buf: jnp.ndarray     # [capacity]
    count: jnp.ndarray   # int32: VALID samples, saturated at capacity


def ring_init(capacity: int, dtype=jnp.complex64) -> RingLog:
    buf = jnp.zeros((capacity,), dtype=dtype)
    return RingLog(buf=buf, count=jnp.int32(0))


def ring_push(ring: RingLog, x: jnp.ndarray) -> RingLog:
    """Append a block (keeps the newest ``capacity`` samples)."""
    cap = ring.buf.shape[0]
    n = x.shape[-1]
    # saturating count: an unbounded total would wrap int32 on long
    # streams, and only the valid-fill level is useful to callers
    new_count = jnp.minimum(ring.count + n, cap).astype(jnp.int32)
    if n >= cap:
        return RingLog(buf=x[-cap:], count=new_count)
    buf = jnp.roll(ring.buf, -n)
    buf = buf.at[cap - n:].set(x)
    return RingLog(buf=buf, count=new_count)


def ring_read(ring: RingLog) -> jnp.ndarray:
    """Time-ordered contents (oldest first; zeros before first wrap —
    the valid suffix has :func:`ring_valid` samples)."""
    return ring.buf


def ring_valid(ring: RingLog) -> jnp.ndarray:
    """Number of valid samples in the view (<= capacity)."""
    return ring.count
