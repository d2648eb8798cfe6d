"""Driver-interface checks (__graft_entry__.py).

The driver compile-checks ``entry()`` single-chip and runs
``dryrun_multichip`` on a virtual device mesh; these tests keep both
callable paths working on the CPU lane.  ``entry()`` is the complex64
synchronizer step.
"""
import jax
import numpy as np
import pytest


def test_entry_compiles_and_runs():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    exe = jax.jit(fn).lower(*args).compile()
    out = exe(*args)
    leaves = jax.tree_util.tree_leaves(out)
    assert leaves, "entry() produced no outputs"
    # the step takes complex64 IQ; an all-zero stream detects nothing
    assert np.asarray(args[1]).dtype == np.complex64
    assert not np.asarray(out[1].detected).any()


@pytest.mark.slow
def test_dryrun_multichip_two_devices():
    import __graft_entry__ as ge
    ge.dryrun_multichip(2)
