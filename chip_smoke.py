"""Smoke test of the receiver on one GPU: the quickest proof it still runs.

Phases, in order, one process, one line each; the last line is one JSON
object:

1. device     — the first JAX device must be a GPU (else exit non-zero);
                prints the card's name and power limit from nvidia-smi.
2. apps       — ``multichannel_tx`` writes 4 channels x 16 packets to an
                IQ file and ``multichannel_rx`` reads it back, both called
                in-process through their ``main(argv)``; all 64 packets
                must be valid.
3. flagship   — ``make_mcrx_batched_step`` at the bench geometry
                (``bench.FLAGSHIP``) over 16 carried calls (16.8 M mixture
                samples) plus the flush; per-channel frame counts and
                payload fingerprints must equal the injected ground truth.
                Compile time and samples/s are printed for information.
4. reference  — each kernel of that path on the card against a float64
                NumPy oracle at the flagship widths (tolerances below).

``--four-cards`` runs only the channel-sharded all-to-all receiver
(``parallel.stream.make_sharded_mcrx_a2a``) on a 2x2 mesh of four GPUs,
and the one-card step it must agree with.

Run: ``python chip_smoke.py`` (one GPU) or ``python chip_smoke.py
--four-cards`` (four GPUs of one host).
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import bench  # noqa: E402

# Float checks compare float32 device results with float64 NumPy; every
# float32 matmul on the checked path runs at Precision.HIGHEST (never
# TF32).  Errors are max |device - oracle| over max |oracle|.
TOL_NCO = 1e-5      # float32 phase of a uint32 DDS word: <= 4e-7 rad
TOL_PFB = 1e-5      # 14 taps per branch + a float32 FFT of <= 128 points
TOL_FFT = 1e-5      # float32 FFT of 48 points
# absolute, on the [0, 1] detect metric, at offsets where every segment
# holds >= METRIC_HEADROOM times the energy gate.  Below that the device's
# float32 running-sum energies (absolute error ~ 1e-7 x the energy summed
# since the window start) decide the gate and the normalization of
# near-silent segments, whose metric stays far under the threshold.
TOL_METRIC = 1e-3
METRIC_HEADROOM = 100.0


def _line(phase: str, card: str, text: str) -> None:
    print(f"{phase}: {text} [{card}]", flush=True)


def _rel_err(got, want) -> float:
    got = np.asarray(got).astype(np.complex128)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                 1e-30))


# ---------------------------------------------------------------------------
# float64 NumPy oracles (independent of the package's formulations)

def nco_mix_oracle(x, phase0: int, freq: int):
    """``x[n] * exp(j 2 pi (phase0 + freq n mod 2^32) / 2^32)``."""
    n = np.arange(len(x), dtype=np.uint64)
    word = (np.uint64(phase0) + np.uint64(freq) * n) % np.uint64(1 << 32)
    return x.astype(np.complex128) * np.exp(
        2j * np.pi * word.astype(np.float64) / float(1 << 32))


def pfb_analysis_oracle(x, h, M: int, frames):
    """Polyphase analysis by its definition, at output ``frames``:
    ``X[n, k] = sum_j h[j] x[nM + M-1-j] exp(j 2 pi j k / M)`` with
    ``x[i < 0] = 0``."""
    L = len(h)
    j = np.arange(L)
    hk = h[:, None] * np.exp(2j * np.pi * np.outer(j, np.arange(M)) / M)
    idx = np.asarray(frames)[:, None] * M + M - 1 - j[None, :]
    xpad = np.concatenate([np.zeros(L, np.complex128),
                           x.astype(np.complex128)])
    return xpad[idx + L] @ hk


def xcorr_metric_oracle(ext, tmpl, span: int, n_metric: int):
    """Segmented-coherent template correlation metric, in the time domain:
    per segment ``s``, ``|sum_i conj(t_s[i]) x[n + s span + i]|^2`` over
    ``E_s[n] * |t_s|^2``, zeroed where ``E_s`` is under 1e-4 of the mean
    energy of a segment, averaged over the segments.

    Returns ``(metric, headroom)``: ``headroom[n]`` is the smallest
    ``E_s[n]`` over that energy gate."""
    ext = ext.astype(np.complex128)
    n_seg = len(tmpl) // span
    xz = np.concatenate([ext, np.zeros(len(tmpl), ext.dtype)])
    pw = np.abs(xz) ** 2
    floor = 1e-4 * span * (np.mean(np.abs(ext) ** 2) + 1e-12)
    win = np.lib.stride_tricks.sliding_window_view(xz, span)
    pwin = np.lib.stride_tricks.sliding_window_view(pw, span).sum(-1)
    acc = np.zeros(n_metric)
    headroom = np.full(n_metric, np.inf)
    for s in range(n_seg):
        seg = tmpl[s * span:(s + 1) * span].astype(np.complex128)
        u = win[s * span: s * span + n_metric] @ np.conj(seg)
        es = pwin[s * span: s * span + n_metric]
        r = np.abs(u) ** 2 / np.maximum(es * np.sum(np.abs(seg) ** 2),
                                        1e-12)
        acc += np.where(es > floor, r, 0.0)
        headroom = np.minimum(headroom, es / floor)
    return acc / n_seg, headroom


def autocorr_metric_oracle(ext, d: int, L: int):
    """Lag-``d`` normalized autocorrelation metric over ``L`` samples:
    ``|sum_i x[n+i] conj(x[n+i+d])|^2 / (E1 E2)`` for every offset,
    zeroed where either energy is under ``1e-4 L`` times the mean
    power.  Returns ``(metric, headroom)`` as :func:`xcorr_metric_oracle`
    does."""
    ext = ext.astype(np.complex128)
    n = len(ext) - d - L + 1
    prod = np.lib.stride_tricks.sliding_window_view(
        ext[:-d] * np.conj(ext[d:]), L)[:n].sum(-1)
    p = np.abs(ext) ** 2
    e1 = np.lib.stride_tricks.sliding_window_view(p[:-d], L)[:n].sum(-1)
    e2 = np.lib.stride_tricks.sliding_window_view(p[d:], L)[:n].sum(-1)
    metric = np.abs(prod) ** 2 / np.maximum(e1 * e2, 1e-12)
    floor = 1e-4 * L * (np.mean(p) + 1e-12)
    return (np.where(np.minimum(e1, e2) > floor, metric, 0.0),
            np.minimum(e1, e2) / floor)


def candidates_oracle(metric, win: int, block: int, threshold: float,
                      k: int):
    """Sorted offsets of the (up to ``k``) strongest local maxima over
    ``+-win`` above ``threshold`` whose offset is in ``[win, block+win)``."""
    padded = np.concatenate([np.full(win, -np.inf), metric,
                             np.full(win, -np.inf)])
    local = np.lib.stride_tricks.sliding_window_view(
        padded, 2 * win + 1).max(-1)
    idx = np.arange(len(metric))
    ok = ((metric >= local) & (metric > threshold)
          & (idx >= win) & (idx < block + win))
    cand = idx[ok]
    return np.sort(cand[np.argsort(-metric[cand], kind="stable")][:k])


# ---------------------------------------------------------------------------
# phases

def phase_apps(card: str) -> None:
    from liquid_usrp_tpu.apps import multichannel_rx, multichannel_tx
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mc.iq")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = multichannel_tx.main(["-o", path, "-n", "4", "-N", "16",
                                       "-P", "400"])
        if rc != 0:
            raise RuntimeError(f"multichannel_tx exited {rc}:\n"
                               f"{buf.getvalue()}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = multichannel_rx.main(["-i", path, "-n", "4"])
    out = buf.getvalue()
    if rc != 0:
        raise RuntimeError(f"multichannel_rx exited {rc}:\n{out}")
    m = re.search(r"valid packets\s*:\s*(\d+)", out)
    valid = int(m.group(1)) if m else -1
    if valid != 64:
        raise AssertionError(f"multichannel_rx: {valid} of 64 packets "
                             f"valid:\n{out[-2000:]}")
    _line("apps", card, f"multichannel_tx -> multichannel_rx: 64/64 "
          f"packets valid in {time.perf_counter() - t0:.1f} s")


def phase_flagship(card: str, n_calls: int = 16, **overrides):
    t0 = time.perf_counter()
    fl = bench.make_flagship(n_calls, **overrides)
    build_s = time.perf_counter() - t0
    run, compile_s, _ = bench.compile_flagship(fl)
    state, frames = bench.run_verified(fl, run)
    windows = bench.time_windows(fl, run, state, n_windows=5)
    med = float(np.median(windows))
    _line("flagship", card,
          f"{n_calls} calls x {fl.g} samples: {frames} frames on "
          f"{fl.cfg['num_channels']} channels, counts "
          f"{fl.expected_counts} and fingerprints exact; compile "
          f"{compile_s:.1f} s, stream build {build_s:.1f} s, "
          f"{n_calls * fl.g / med:.4g} samples/s (median of 5 windows)")
    return fl


def check_nco(fl) -> float:
    import jax
    from liquid_usrp_tpu.models.multichannel import _center_offset
    from liquid_usrp_tpu.ops import nco
    x = fl.calls[0]
    st = nco.nco_init(-_center_offset(fl.cfg["num_channels"]), phase=1.0)
    _, y = jax.jit(lambda s, v: nco.nco_mix_block(s, v, up=True))(st, x)
    want = nco_mix_oracle(np.asarray(x), int(st.phase), int(st.freq))
    err = _rel_err(y, want)
    if not err <= TOL_NCO:
        raise AssertionError(f"NCO mix: error {err:.3g} > {TOL_NCO}")
    return err


def check_pfb(x, n_bins: int) -> float:
    import jax
    from liquid_usrp_tpu.ops import pfb
    ch = pfb.pfbch_create(n_bins, m=7, As=60.0)
    _, X = jax.jit(lambda v: pfb.pfb_analyze_block(
        ch, pfb.pfbch_state(ch), v))(x)
    n = X.shape[0]
    frames = np.unique(np.concatenate([np.arange(min(64, n)),
                                       np.linspace(0, n - 1, 2048)
                                       .astype(int)]))
    h = ch.h_pol.reshape(-1).astype(np.float64)
    want = pfb_analysis_oracle(np.asarray(x), h, n_bins, frames)
    err = _rel_err(np.asarray(X)[frames], want)
    if not err <= TOL_PFB:
        raise AssertionError(f"PFB {n_bins} bins: error {err:.3g} > "
                             f"{TOL_PFB}")
    return err


def check_detect(fl, ext) -> tuple[float, int]:
    import jax
    from liquid_usrp_tpu.framing import ofdm_sync
    from liquid_usrp_tpu.framing.ofdm import NUM_S0
    sync = fl.sync
    M = sync.params.M
    metric, (det, locs, _) = jax.jit(lambda e: (
        ofdm_sync._detect_metric_xcorr(sync, e),
        ofdm_sync._detect_candidates(sync, e)))(ext)
    tmpl = np.tile(sync.params.s0_time, NUM_S0)
    want, headroom = xcorr_metric_oracle(np.asarray(ext), tmpl,
                                         ofdm_sync._xc_span(len(tmpl)),
                                         metric.shape[0])
    lit = headroom >= METRIC_HEADROOM
    err = float(np.max(np.abs(np.asarray(metric) - want)[lit]))
    if not err <= TOL_METRIC:
        raise AssertionError(f"detect metric: error {err:.3g} > "
                             f"{TOL_METRIC}")
    got = np.sort(np.asarray(locs)[np.asarray(det)])
    cand = candidates_oracle(want, M, sync.block_size, sync.threshold,
                             sync.max_frames)
    if not len(cand) or not np.array_equal(got, cand):
        raise AssertionError(f"detect candidates differ or are absent: "
                             f"device {got}, oracle {cand}")
    return err, len(got)


def check_demod_fft(fl) -> float:
    import jax
    import jax.numpy as jnp
    sync = fl.sync
    rows = (fl.cfg["num_channels"] * fl.cfg["batched_blocks"]
            * sync.max_frames * sync.max_psym)
    rng = np.random.default_rng(48)
    y = (rng.standard_normal((rows, sync.params.M))
         + 1j * rng.standard_normal((rows, sync.params.M))
         ).astype(np.complex64)
    got = jax.jit(lambda v: jnp.fft.fft(v, axis=-1))(jnp.asarray(y))
    err = _rel_err(got, np.fft.fft(y.astype(np.complex128), axis=-1))
    if not err <= TOL_FFT:
        raise AssertionError(f"demod FFT: error {err:.3g} > {TOL_FFT}")
    return err


def check_codes(fl) -> int:
    """CRC-32 against zlib, and Golay(24,12) / Hamming(12,8) decode of
    codewords carrying the most errors each code corrects; all exact."""
    import jax
    import jax.numpy as jnp
    from liquid_usrp_tpu.ops import crc, fec
    from liquid_usrp_tpu.utils.bits import np_pack_bits, np_unpack_bits
    rows = fl.cfg["num_channels"] * fl.cfg["batched_blocks"] * \
        fl.sync.max_frames
    rng = np.random.default_rng(32)
    data = rng.integers(0, 256, (rows, fl.sync.dec_max), dtype=np.uint8)
    got = np.asarray(jax.jit(lambda d: crc.crc_compute(crc.CRC_32, d))(
        jnp.asarray(data)))
    want = np.array([zlib.crc32(r.tobytes()) for r in data], np.uint32)
    if not np.array_equal(got, want):
        raise AssertionError("CRC-32 differs from zlib")
    for scheme, t in ((fec.FEC_GOLAY2412, 3), (fec.FEC_HAMMING128, 1)):
        c = fec._block_code(scheme)
        msg = rng.integers(0, 256, (rows, 96), dtype=np.uint8)
        bits = np_unpack_bits(msg.reshape(-1)).reshape(rows, -1, c.k)
        cw = (bits.astype(np.int64) @ c.G.astype(np.int64)) % 2
        # t bit errors per codeword, at distinct random positions
        pos = np.argsort(rng.random(cw.shape), axis=-1)[..., :t]
        np.put_along_axis(cw, pos, 1 - np.take_along_axis(cw, pos, -1),
                          axis=-1)
        coded = np_pack_bits(cw.reshape(-1).astype(np.uint8)).reshape(
            rows, -1)
        dec = np.asarray(jax.jit(lambda v: fec.fec_decode(
            scheme, v, msg.shape[1]))(jnp.asarray(coded)))
        if not np.array_equal(dec, msg):
            raise AssertionError(f"{fec.fec_name(scheme)} decode is not "
                                 "exact")
    return rows


def phase_reference(card: str, fl) -> None:
    import jax
    import jax.numpy as jnp
    from liquid_usrp_tpu.models.multichannel import _center_offset
    from liquid_usrp_tpu.ops import nco, pfb
    N = fl.cfg["num_channels"]
    e_nco = check_nco(fl)
    # the flagship's own channelizer input: the first call, mixed down
    _, mixed = jax.jit(lambda v: nco.nco_mix_block(
        nco.nco_init(-_center_offset(N)), v, up=True))(fl.calls[0])
    e_pfb8 = check_pfb(mixed, 2 * N)
    e_pfb128 = check_pfb(mixed, 128)
    # channel 0's extended window (carried overlap + one block) ending at
    # the end of the first call
    ch = pfb.pfbch_create(2 * N, m=7, As=60.0)
    _, X = pfb.pfb_analyze_block(ch, pfb.pfbch_state(ch), mixed)
    n_ext = fl.sync.overlap + fl.sync.block_size
    ext = jnp.concatenate([jnp.zeros(max(n_ext - X.shape[0], 0),
                                     jnp.complex64),
                           X[max(X.shape[0] - n_ext, 0):, 0]])
    e_det, n_cand = check_detect(fl, ext)
    e_fft = check_demod_fft(fl)
    n_rows = check_codes(fl)
    _line("reference", card,
          f"NCO mix err {e_nco:.2e} (tol {TOL_NCO:g}); PFB 8 bins err "
          f"{e_pfb8:.2e}, 128 bins err {e_pfb128:.2e} (tol {TOL_PFB:g}); "
          f"S0 xcorr metric err {e_det:.2e} (tol {TOL_METRIC:g}), "
          f"{n_cand} candidate offsets equal; M=48 FFT err {e_fft:.2e} "
          f"(tol {TOL_FFT:g}); CRC-32, Golay(24,12), Hamming(12,8) exact "
          f"on {n_rows} rows")


def sharded_fingerprints(res, weights, num_channels: int):
    """Per-channel ``(counts, fingerprints)`` of valid payloads in a
    sharded receiver's host results (leaves ``[N, rows, ...]``)."""
    counts, fps = [], []
    for ch in range(num_channels):
        ok = np.asarray(res.payload_valid[ch])
        pay = np.asarray(res.payload[ch])[ok].astype(np.uint64)
        counts.append(int(ok.sum()))
        fps.append(int((pay * weights.astype(np.uint64)).sum())
                   & 0xFFFFFFFF)
    return counts, fps


def phase_four_cards(card: str, n_calls: int = 16, devices=None,
                     **overrides) -> dict:
    """The channel-sharded all-to-all receiver on a 2x2 mesh of four
    devices against the one-card step on the same mixture."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from liquid_usrp_tpu.parallel import mesh as mesh_mod
    from liquid_usrp_tpu.parallel import stream as pstream

    fl = bench.make_flagship(n_calls, **overrides)
    run1, _, _ = bench.compile_flagship(fl)
    _, frames = bench.run_verified(fl, run1)

    mesh = (mesh_mod.make_sdr_mesh(4) if devices is None else
            jax.make_mesh((2, 2), ("time", "channel"), devices=devices))
    n_dev = mesh.devices.size
    n_ch = mesh.shape["channel"]
    N, bs = fl.cfg["num_channels"], fl.sync.block_size
    chunk_blocks = max(1, -(-fl.sync.overlap // (bs * n_ch)))
    per_step = n_dev * 2 * N * bs * chunk_blocks
    total = n_calls * fl.g
    if total % per_step:
        raise ValueError(f"stream of {total} samples is not a whole "
                         f"number of {per_step}-sample super-steps")
    n_steps = total // per_step
    run = pstream.make_sharded_mcrx_a2a(mesh, N, fl.sync, chunk_blocks,
                                        n_steps=n_steps)
    # the input layout make_sharded_mcrx_a2a takes: [n_steps, per_step]
    # rows sharded over the flattened mesh (one flat row for one step)
    stream = jnp.concatenate(fl.calls)
    if n_steps > 1:
        stream, spec = (stream.reshape(n_steps, per_step),
                        P(None, ("time", "channel")))
    else:
        spec = P(("time", "channel"))
    stream = jax.device_put(stream, NamedSharding(mesh, spec))
    t0 = time.perf_counter()
    out = run.jit_fn(stream)
    jax.block_until_ready(out)
    first_s = time.perf_counter() - t0

    def shares(arrays):
        by_dev = {}
        for a in jax.tree_util.tree_leaves(arrays):
            for s in a.addressable_shards:
                by_dev[s.device.id] = by_dev.get(s.device.id, 0) + \
                    s.data.nbytes
        return by_dev

    in_b, out_b = shares(stream), shares(out)
    res = jax.tree.map(run.regroup, jax.tree.map(np.asarray, out))
    counts, fps = sharded_fingerprints(res, fl.weights, N)
    if counts != fl.expected_counts or fps != fl.expected_fps:
        raise AssertionError(
            f"four-card decode differs from the one-card step: counts "
            f"{counts} vs {fl.expected_counts}, fingerprints "
            f"{[hex(f) for f in fps]} vs "
            f"{[hex(f) for f in fl.expected_fps]}")
    if len(in_b) != n_dev or len(out_b) != n_dev:
        raise AssertionError(f"work not spread over {n_dev} devices: "
                             f"input {in_b}, output {out_b}")
    _line("four-cards", card,
          f"mesh time={mesh.shape['time']} x channel={n_ch}, {n_steps} "
          f"super-steps of {per_step} samples: counts {counts} and "
          f"fingerprints equal the one-card step ({frames} frames); "
          f"compile+first run {first_s:.1f} s; input bytes per device "
          f"{in_b}; output bytes per device {out_b}")
    return {"counts": counts, "in_bytes": in_b, "out_bytes": out_b}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU sharded receiver and its "
                         "one-card comparison")
    args = ap.parse_args(argv)
    dev = bench.require_gpu()
    import jax
    from liquid_usrp_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    card = bench.card_info()
    print(card, flush=True)
    _line("device", card, f"platform={dev.platform} kind={dev.device_kind}"
          f" count={len(jax.devices())}")
    if args.four_cards:
        if len(jax.devices()) < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs, found "
                             f"{len(jax.devices())}")
        phase_four_cards(card)
    else:
        phase_apps(card)
        fl = phase_flagship(card)
        phase_reference(card, fl)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
