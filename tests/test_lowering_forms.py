"""Semantic locks for the gather-free and O(1)-per-sample lowering forms.

Each of these ops replaces a direct formulation (a traced index-array
gather under the candidate vmap; an O(window) reduce_window NMS) with a
form that lowers better on some backend.  The rewrites are only legal
because they are exactly equivalent to the forms they replaced; these
tests pin that equivalence against the direct reference formulations.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from liquid_usrp_tpu.framing import payload as payload_codec
from liquid_usrp_tpu.ops import modem as modem_mod
from liquid_usrp_tpu.ops.corr import sliding_max


@pytest.mark.parametrize("n,radius", [(5, 1), (97, 48), (1000, 3),
                                      (4096, 96), (65633, 48)])
def test_sliding_max_equals_reduce_window(n, radius):
    """sliding_max (one reduce_window) against a NumPy sliding max over
    the -inf padded signal."""
    rng = np.random.default_rng(n + radius)
    x = rng.standard_normal(n).astype(np.float32)
    pad = np.concatenate([np.full(radius, -np.inf, np.float32), x,
                          np.full(radius, -np.inf, np.float32)])
    want = np.lib.stride_tricks.sliding_window_view(
        pad, 2 * radius + 1).max(-1)
    np.testing.assert_array_equal(
        np.asarray(sliding_max(jnp.asarray(x), radius)), want)


@pytest.mark.parametrize("scheme", [1, 2, 9, 17, 24, 40])  # bps 1,2,4,6...
def test_bits_from_syms_equals_gather_form(scheme):
    """The per-static-bps layout select must reproduce the direct
    ``sym[j // bps + off]`` gather for every in-range bit."""
    rng = np.random.default_rng(scheme)
    bps = modem_mod.bits_per_symbol(scheme)
    n = 257
    max_bits = (n - 2) * bps          # stays within the symbol stream
    sym = jnp.asarray(rng.integers(0, 1 << bps, n), jnp.int32)
    for off_v in (0, 1):
        off = jnp.int32(off_v)
        got = payload_codec._bits_from_syms(
            sym, off, jnp.int32(bps), max_bits)
        j = np.arange(max_bits)
        src = np.clip(j // bps + off_v, 0, n - 1)
        want = (np.asarray(sym)[src] >> (bps - 1 - j % bps)) & 1
        np.testing.assert_array_equal(np.asarray(got), want.astype(np.uint8))


@pytest.mark.parametrize("scheme", [2, 9, 17, 31, 40])
def test_nearest_point_equals_table_gather(scheme):
    """Value-carrying argmin == tab[argmin] (incl. tie-breaking by
    first occurrence, which the shared strict-< update guarantees)."""
    rng = np.random.default_rng(scheme + 7)
    tab = jnp.asarray(payload_codec._stacked_tables())[scheme]
    x = jnp.asarray((rng.standard_normal(500) +
                     1j * rng.standard_normal(500)).astype(np.complex64))
    sym, dmin_s = payload_codec._nearest_sym(x, tab)
    dec, dmin_p = payload_codec._nearest_point(x, tab)
    np.testing.assert_array_equal(np.asarray(tab)[np.asarray(sym)],
                                  np.asarray(dec))
    np.testing.assert_allclose(np.asarray(dmin_s), np.asarray(dmin_p),
                               rtol=0, atol=0)


def test_nearest_point_exact_tie_breaks_first():
    # two identical table entries: both forms must pick the first
    tab = jnp.asarray(np.array([1 + 1j, 1 + 1j, -1 - 1j] + [1e6 + 0j] * 13,
                               np.complex64))
    x = jnp.asarray(np.array([1 + 1j, -1 - 1j, 0.1 + 0.1j], np.complex64))
    sym, _ = payload_codec._nearest_sym(x, tab)
    dec, _ = payload_codec._nearest_point(x, tab)
    assert np.asarray(sym).tolist() == [0, 2, 0]
    np.testing.assert_array_equal(np.asarray(tab)[np.asarray(sym)],
                                  np.asarray(dec))
