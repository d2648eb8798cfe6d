"""Multi-host launch helpers.

The reference is strictly single-host (SURVEY.md §2.2 — its only transport
is UHD + pthread shared memory).  This framework scales across hosts by
initializing the JAX distributed runtime and building the ``(time,
channel)`` mesh over the global device set; halo/state exchange then rides
the interconnect (NVLink within a host, the network across hosts)
through the mesh axes (the BASELINE.json >=80% 1->N-host scaling target).

Typical multi-process launch (same program in every process):

    from liquid_usrp_tpu.parallel import distributed, mesh, stream
    distributed.init("localhost:1234", 4, rank)   # or the JAX_* env vars
    m = mesh.make_sdr_mesh()                 # all global devices
    run = stream.make_sharded_mcrx_a2a(m, num_channels, sync, blocks)

For single-process simulation of a multi-host topology use
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` (what the test
suite and the driver's dryrun do).
"""
from __future__ import annotations

import os

import jax

__all__ = ["init", "is_distributed", "local_info"]

_initialized = False


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None) -> None:
    """Initialize jax.distributed (idempotent; env-driven when args absent).

    Pass the coordinator explicitly or via ``JAX_COORDINATOR_ADDRESS``/
    ``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID`` (e.g. ``localhost:<port>`` on
    one multi-GPU host); nothing is discovered automatically.
    """
    global _initialized
    if _initialized:
        return
    kwargs = {}
    if coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        kwargs["coordinator_address"] = (
            coordinator_address or os.environ["JAX_COORDINATOR_ADDRESS"])
    if num_processes or os.environ.get("JAX_NUM_PROCESSES"):
        kwargs["num_processes"] = int(
            num_processes or os.environ["JAX_NUM_PROCESSES"])
    if process_id is not None or os.environ.get("JAX_PROCESS_ID"):
        kwargs["process_id"] = int(
            process_id if process_id is not None
            else os.environ["JAX_PROCESS_ID"])
    # a single process with no coordinator forms no group: stay unlatched
    # so a later explicit init() with real coordinator args still works
    if kwargs.get("num_processes", 1) > 1 or "coordinator_address" in kwargs:
        jax.distributed.initialize(**kwargs)
        _initialized = True


def is_distributed() -> bool:
    return jax.process_count() > 1


def local_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
