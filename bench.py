"""Benchmark: decode-verified IQ throughput of the flagship receiver on a GPU.

Runs the flagship multichannel RX — NCO mix -> 2N-bin PFB analyzer -> N
vmapped OFDM flexframe synchronizers (``make_mcrx_batched_step``) — on the
first GPU, in one process, and verifies it there: the input mixture
carries a known set of injected frames, and the measurement only counts
if every frame decodes payload-exact.  Prints exactly one JSON line.

Geometry (``FLAGSHIP``): 4 channels, M=48 / cp=6 / taper=4 OFDM, 400-B
payloads under a 512-B decode budget, 65536-sample blocks two at a time
(one call is 2N * 65536 * 2 = 1,048,576 complex64 mixture samples), 24
candidates per block, every channel loaded with back-to-back frames plus
0.01 complex noise.

``vs_baseline`` compares against 8 MS/s — the reference system's real-time
envelope (USRP single-carrier bandwidth ceiling, liquid-usrp
src/flexframe_tx.cc:37 "8MHz max").

Run: ``python bench.py`` (exits non-zero without a GPU).
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

BASELINE_SPS = 8e6   # reference real-time envelope (8 MS/s USRP ceiling)

FLAGSHIP = dict(num_channels=4, M=48, cp_len=6, taper_len=4,
                payload_len=400, max_payload=512, block_size=65536,
                batched_blocks=2, max_frames=24, noise=0.01)

# Published peaks per device_kind: (dense bf16 FLOP/s, HBM bytes/s).
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense rates
# without sparsity, at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
}


def device_peaks(kind: str) -> tuple[float, float]:
    """``(bf16 FLOP/s, HBM bytes/s)`` for a device kind; unknown is an
    error, never a silent default."""
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(f"no published peaks for device kind {kind!r}; "
                         f"known: {sorted(PEAKS)}") from None


def require_gpu():
    """The first JAX device, which must be a GPU; exits non-zero otherwise
    (a CPU rate must never be reported as a device number)."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found platform "
                         f"{dev.platform!r} ({dev.device_kind})")
    return dev


def card_info() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _build_loaded_mixture(N, params, props, payload_len, total_channel_samps,
                          margin, rng):
    """Per-channel back-to-back frames -> synthesized centered mixture.

    Returns ``(mixture[2N*total], payloads)`` where ``payloads[ch]`` is the
    ordered list of injected payload byte arrays for channel ``ch`` — the
    decode ground truth.
    """
    import jax.numpy as jnp
    from liquid_usrp_tpu.framing import ofdm
    from liquid_usrp_tpu.models.multichannel import make_mctx_step

    flen = ofdm.frame_length(params, props, payload_len)
    gap = 128
    n_frames = max(1, (total_channel_samps - margin) // (flen + gap))
    payloads = []
    streams = np.zeros((total_channel_samps, N), np.complex64)
    for ch in range(N):
        hdrs = rng.integers(0, 256, (n_frames, 8), dtype=np.uint8)
        pays = rng.integers(0, 256, (n_frames, payload_len), dtype=np.uint8)
        frames = np.asarray(ofdm.assemble_frames(
            params, props, jnp.asarray(hdrs), jnp.asarray(pays)))
        for i in range(n_frames):
            pos = i * (flen + gap)
            streams[pos:pos + flen, ch] = frames[i]
        payloads.append(list(pays))
    init, step = make_mctx_step(N)
    Y = np.zeros((total_channel_samps, 2 * N), np.complex64)
    Y[:, :N] = streams
    st = init()
    out = []
    for lo in range(0, total_channel_samps, 1 << 15):
        st, y = step(st, jnp.asarray(Y[lo:lo + (1 << 15)]))
        out.append(np.asarray(y))
    return np.concatenate(out), payloads


def expected_fingerprints(payloads, weights, max_payload):
    """Host-side order-independent uint32 fingerprints per channel:
    ``sum over frames of sum_i payload[i] * weights[i]`` mod 2^32, with
    each payload zero-padded to ``max_payload``.  Returns
    ``(counts, fingerprints)``."""
    fps, counts = [], []
    for per_ch in payloads:
        acc = 0
        for p in per_ch:
            pad = np.zeros(max_payload, np.uint64)
            pad[: len(p)] = p
            acc = (acc + int((pad * weights.astype(np.uint64)).sum())) \
                & 0xFFFFFFFF
        fps.append(acc)
        counts.append(len(per_ch))
    return counts, fps


def make_flagship(n_calls: int, seed: int = 0, **overrides):
    """Build the flagship receiver and a loaded, ground-truthed stream of
    ``n_calls`` consecutive calls (plus noise-only flush calls), on the
    default device.  ``overrides`` change ``FLAGSHIP`` fields (tests use
    small blocks)."""
    import jax.numpy as jnp
    from liquid_usrp_tpu.framing import ofdm, ofdm_sync
    from liquid_usrp_tpu.models.multichannel import make_mcrx_batched_step

    cfg = dict(FLAGSHIP, **overrides)
    N, nb = cfg["num_channels"], cfg["batched_blocks"]
    params = ofdm.make_ofdm_params(M=cfg["M"], cp_len=cfg["cp_len"],
                                   taper_len=cfg["taper_len"])
    sync = ofdm_sync.make_sync(params, block_size=cfg["block_size"],
                               max_payload=cfg["max_payload"],
                               max_frames=cfg["max_frames"])
    init_state, step = make_mcrx_batched_step(N, sync, nb)
    g = 2 * N * sync.block_size * nb          # mixture samples per call
    rng = np.random.default_rng(seed)
    weights = rng.integers(0, 1 << 32, sync.max_payload, dtype=np.uint32)
    total = n_calls * sync.block_size * nb
    margin = sync.overlap + 8 * params.M
    mixture, payloads = _build_loaded_mixture(
        N, params, ofdm.default_props(), cfg["payload_len"], total, margin,
        rng)
    noise = (rng.standard_normal(mixture.shape)
             + 1j * rng.standard_normal(mixture.shape)).astype(np.complex64)
    blocks = (mixture + cfg["noise"] * noise).reshape(n_calls, g)
    # frames near the stream end decode up to overlap/block_size blocks
    # late: flush with noise until the carried overlap has drained
    n_flush = -(-(sync.overlap // sync.block_size + 1) // nb)
    flush = (cfg["noise"] * (rng.standard_normal((n_flush, g))
                             + 1j * rng.standard_normal((n_flush, g)))
             ).astype(np.complex64)
    counts, fps = expected_fingerprints(payloads, weights, sync.max_payload)
    return SimpleNamespace(
        cfg=cfg, sync=sync, init_state=init_state, step=step, g=g,
        calls=[jnp.asarray(b) for b in blocks],
        flush=[jnp.asarray(b) for b in flush],
        weights=weights, expected_counts=counts, expected_fps=fps)


def fingerprint_step(step, weights):
    """Jitted ``(state, acc, x) -> (state', acc')`` around ``step``:
    ``acc = (count[N] int32, fingerprint[N] uint32)`` accumulates valid
    payloads on the device (uint32 sums wrap mod 2^32), so a run of calls
    moves only 2N scalars back to the host."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(state, acc, x):
        state, res = step(state, x)
        ok = res.payload_valid                        # [N, nb, K]
        row_fp = jnp.sum(res.payload.astype(jnp.uint32)
                         * jnp.asarray(weights), axis=-1)
        red = tuple(range(1, ok.ndim))
        cnt = jnp.sum(ok, axis=red).astype(jnp.int32)
        fp = jnp.sum(jnp.where(ok, row_fp, jnp.uint32(0)), axis=red,
                     dtype=jnp.uint32)
        return state, (acc[0] + cnt, acc[1] + fp)

    return run


def compile_flagship(fl):
    """AOT-compile the fingerprinted step once; returns ``(executable,
    compile seconds, XLA cost analysis dict)``."""
    run = fingerprint_step(fl.step, fl.weights)
    t0 = time.perf_counter()
    exe = run.lower(fl.init_state(), zero_acc(fl.cfg["num_channels"]),
                    fl.calls[0]).compile()
    compile_s = time.perf_counter() - t0
    cost = exe.cost_analysis()
    cost = (cost[0] if isinstance(cost, (list, tuple)) else cost) or {}
    return exe, compile_s, cost


def zero_acc(num_channels: int):
    import jax.numpy as jnp
    return (jnp.zeros(num_channels, jnp.int32),
            jnp.zeros(num_channels, jnp.uint32))


def check_decode(fl, counts, fps) -> int:
    """Raise unless per-channel frame counts and payload fingerprints equal
    the injected ground truth exactly; return the number of frames."""
    counts = [int(c) for c in np.asarray(counts)]
    fps = [int(f) for f in np.asarray(fps)]
    for ch, (c, f) in enumerate(zip(counts, fps)):
        if c != fl.expected_counts[ch]:
            raise AssertionError(f"channel {ch}: decoded {c} frames, "
                                 f"injected {fl.expected_counts[ch]}")
        if f != fl.expected_fps[ch]:
            raise AssertionError(f"channel {ch}: payload fingerprint "
                                 f"{f:#010x} != {fl.expected_fps[ch]:#010x}")
    return sum(counts)


def run_verified(fl, run, state=None):
    """Feed every call of the stream, then the flush, through ``run``
    (carried state); check the decode.  Returns ``(state', frames)``."""
    import jax
    state = fl.init_state() if state is None else state
    acc = zero_acc(fl.cfg["num_channels"])
    for x in fl.calls + fl.flush:
        state, acc = run(state, acc, x)
    counts, fps = jax.device_get(acc)
    return state, check_decode(fl, counts, fps)


def time_windows(fl, run, state, n_windows: int) -> list[float]:
    """Wall seconds of ``n_windows`` windows, each feeding every call of
    the stream once and ending in ``block_until_ready``."""
    import jax
    acc = zero_acc(fl.cfg["num_channels"])
    out = []
    for _ in range(n_windows):
        t0 = time.perf_counter()
        for x in fl.calls:
            state, acc = run(state, acc, x)
        jax.block_until_ready((state, acc))
        out.append(time.perf_counter() - t0)
    return out


def main() -> int:
    dev = require_gpu()
    import jax
    from liquid_usrp_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    card = card_info()
    peak_flops, peak_bw = device_peaks(dev.device_kind)

    n_calls = 16
    fl = make_flagship(n_calls)
    run, compile_s, cost = compile_flagship(fl)
    state, frames = run_verified(fl, run)
    windows = time_windows(fl, run, state, n_windows=7)
    med = statistics.median(windows)
    sps = n_calls * fl.g / med
    flops_s = float(cost.get("flops", 0.0)) * n_calls / med
    bytes_s = float(cost.get("bytes accessed", 0.0)) * n_calls / med
    print(json.dumps({
        "metric": "mcrx_iq_throughput",
        "value": sps,
        "unit": "samples/s/chip",
        "vs_baseline": sps / BASELINE_SPS,
        "correct": True,
        "frames_verified": frames,
        "window_s": windows,
        "window_calls": n_calls,
        "compile_s": compile_s,
        "flops_per_s": flops_s,
        "hbm_bytes_per_s": bytes_s,
        "mfu": flops_s / peak_flops,
        "hbm_util": bytes_s / peak_bw,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
