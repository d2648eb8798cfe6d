"""CPU checks of the GPU harness (bench.py, chip_smoke.py).

Both scripts refuse a non-GPU platform; their decode-verification,
fingerprint and reference machinery is exercised here at small sizes.
The timings they print exist only on the GPU.
"""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
import chip_smoke
from liquid_usrp_tpu.framing import ofdm, ofdm_sync
from liquid_usrp_tpu.ops import nco

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(block_size=8192, max_frames=8)


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_refuses_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, script)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr
    assert not [ln for ln in out.stdout.splitlines()
                if ln.lstrip().startswith("{")]


def test_device_peaks():
    assert bench.device_peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    with pytest.raises(ValueError, match="no published peaks"):
        bench.device_peaks("cpu")


def test_expected_fingerprints_hand_sum():
    w = np.array([1, 2, 3, 0xFFFFFFFF], np.uint32)
    payloads = [[np.array([1, 1], np.uint8), np.array([2, 0, 1], np.uint8)],
                [np.array([255, 255, 255, 255], np.uint8)]]
    counts, fps = bench.expected_fingerprints(payloads, w, 4)
    assert counts == [2, 1]
    # ch0: (1*1 + 1*2) + (2*1 + 0*2 + 1*3) = 8
    # ch1: 255 * (1 + 2 + 3 + 0xFFFFFFFF) mod 2^32 = 255 * 5
    assert fps == [8, 255 * 5]


def test_flagship_decode_verified_small():
    fl = bench.make_flagship(2, **SMALL)
    run, _, _ = bench.compile_flagship(fl)
    _, frames = bench.run_verified(fl, run)
    assert frames == sum(fl.expected_counts) > 0
    # a wrong ground truth must be caught
    fl.expected_fps = [f ^ 1 for f in fl.expected_fps]
    with pytest.raises(AssertionError, match="fingerprint"):
        bench.run_verified(fl, run)


def test_nco_oracle():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)
         ).astype(np.complex64)
    st = nco.nco_init(-0.3 * np.pi, phase=2.0)
    _, y = nco.nco_mix_block(st, jnp.asarray(x), up=True)
    want = chip_smoke.nco_mix_oracle(x, int(st.phase), int(st.freq))
    assert chip_smoke._rel_err(y, want) <= chip_smoke.TOL_NCO


@pytest.mark.parametrize("n_bins", [8, 128])
def test_pfb_oracle(n_bins):
    rng = np.random.default_rng(n_bins)
    x = jnp.asarray((rng.standard_normal(n_bins * 96)
                     + 1j * rng.standard_normal(n_bins * 96))
                    .astype(np.complex64))
    assert chip_smoke.check_pfb(x, n_bins) <= chip_smoke.TOL_PFB


def test_codes_exact():
    params = ofdm.make_ofdm_params(M=48, cp_len=6, taper_len=4)
    sync = ofdm_sync.make_sync(params, block_size=8192, max_payload=64,
                               max_frames=2)
    fl = SimpleNamespace(cfg=dict(num_channels=2, batched_blocks=1),
                         sync=sync)
    assert chip_smoke.check_codes(fl) == 4


def test_four_cards_on_virtual_devices():
    """The --four-cards path (2x2 mesh) on four of the suite's virtual
    CPU devices: counts and fingerprints equal the one-card step, and
    every device holds a share of the input and output."""
    out = chip_smoke.phase_four_cards("cpu", n_calls=4,
                                      devices=jax.devices()[:4], **SMALL)
    assert sum(out["counts"]) > 0
    assert len(out["in_bytes"]) == len(out["out_bytes"]) == 4
    assert len(set(out["in_bytes"].values())) == 1


def test_last_line_contract(capsys, monkeypatch):
    """chip_smoke's last line is exactly the device JSON object."""
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    for name in ("phase_apps", "phase_reference"):
        monkeypatch.setattr(chip_smoke, name, lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "phase_flagship", lambda *a, **k: None)
    monkeypatch.setattr(bench, "require_gpu", lambda: dev)
    monkeypatch.setattr(bench, "card_info",
                        lambda: "NVIDIA H100 80GB HBM3, 400.00 W")
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
        "count": len(jax.devices())}}
