"""Test configuration: force an 8-device virtual CPU mesh before JAX init.

Mirrors the multi-host simulation strategy in SURVEY.md §4: sharding paths are
validated on ``--xla_force_host_platform_device_count=8`` CPU devices standing
in for a multi-GPU host; ``chip_smoke.py --four-cards`` runs the sharded
receiver on real cards.

Both the env var and the live jax config are set (XLA_FLAGS has to land
before first backend use).  The persistent compile cache stays off here:
the apps place it when they parse their flags, and tests that call an
app's ``main`` in-process must not write compiled CPU programs into the
repository; tests/test_compile_cache.py checks the cache in subprocesses.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled-executable caches after each test module.

    The full slow lane in one process accumulates hundreds of compiled
    programs; at that load the XLA:CPU compiler segfaulted twice inside
    ``backend_compile_and_load`` (r05, rc=139 near the lane's end) while
    every module-level subset passes.  Bounding the in-process compiler
    state removes the trigger; cross-module executable reuse is rare, so
    the recompile cost is small.
    """
    yield
    import jax

    jax.clear_caches()
