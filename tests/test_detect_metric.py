"""The OFDM detect metrics against independent float64 NumPy oracles.

``_detect_metric`` (lag-M/4 autocorrelation, cumulative sums) and
``_detect_metric_xcorr`` (segmented S0 cross-correlation, FFT domain) are
checked against the time-domain definitions in ``chip_smoke.py``, which
also runs the xcorr check at the flagship width on the GPU.  Offsets
whose window energy is near the silence gate are left out: there the
float32 running sums, not the metric's definition, decide the value.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import (METRIC_HEADROOM, TOL_METRIC, autocorr_metric_oracle,
                        candidates_oracle, xcorr_metric_oracle)
from liquid_usrp_tpu.framing import ofdm, ofdm_sync
from liquid_usrp_tpu.framing.ofdm import NUM_S0


def _ext(M: int):
    params = ofdm.make_ofdm_params(M=M, cp_len=M // 8, taper_len=M // 16)
    sync = ofdm_sync.make_sync(params, block_size=4096, max_payload=32,
                               max_frames=4)
    rng = np.random.default_rng(M)
    frame = np.asarray(ofdm.assemble_frame(
        params, ofdm.default_props(),
        jnp.asarray(rng.integers(0, 256, 8, dtype=np.uint8)),
        jnp.asarray(rng.integers(0, 256, 20, dtype=np.uint8))))
    ext = 0.01 * (rng.standard_normal(sync.overlap + 4096)
                  + 1j * rng.standard_normal(sync.overlap + 4096))
    start = sync.overlap + 700
    ext[start:start + len(frame)] += frame
    return sync, ext.astype(np.complex64), start


@pytest.mark.parametrize("metric", ["autocorr", "xcorr"])
@pytest.mark.parametrize("M", [48, 64, 128, 256])
def test_detect_metric_matches_oracle(M, metric):
    sync, ext, start = _ext(M)
    if metric == "xcorr":
        got = np.asarray(ofdm_sync._detect_metric_xcorr(sync,
                                                        jnp.asarray(ext)))
        tmpl = np.tile(sync.params.s0_time, NUM_S0)
        want, headroom = xcorr_metric_oracle(
            ext, tmpl, ofdm_sync._xc_span(len(tmpl)), got.shape[0])
    else:
        d = M // 4
        got = np.asarray(ofdm_sync._detect_metric(sync,
                                                  jnp.asarray(ext))[0])
        want, headroom = autocorr_metric_oracle(ext, d, NUM_S0 * M - d)
    lit = headroom >= METRIC_HEADROOM
    assert lit[start:start + M].all()
    np.testing.assert_allclose(got[lit], want[lit], rtol=0,
                               atol=TOL_METRIC)
    # the frame is the one strong peak, and it is found where it was put
    peak = int(np.argmax(np.where(lit, want, 0.0)))
    assert abs(peak - start) <= M and want[peak] > 0.5
    if metric == "xcorr":
        det, locs = ofdm_sync._find_candidates(sync, jnp.asarray(got))
        cand = candidates_oracle(want, M, sync.block_size, sync.threshold,
                                 sync.max_frames)
        np.testing.assert_array_equal(
            np.sort(np.asarray(locs)[np.asarray(det)]), cand)
