"""Scaling-overhead harness for the all-to-all sharded receiver.

One host cannot measure true multi-chip scaling (the 8 virtual CPU devices
share the same cores, so per-device throughput necessarily falls as the
mesh grows).  What the virtual mesh CAN measure is **sharding overhead**:
process the SAME total workload (a) on a 1-device mesh and (b) sharded over
n devices — on shared silicon the ideal time is constant, so
``T_n / T_1`` isolates the cost the a2a decomposition adds (halo
duplication, collective schedule, regrouping).  The interconnect term of
the real multi-chip argument needs real cards
(``chip_smoke.py --four-cards`` runs the sharded receiver on four GPUs).

Each mesh size runs in a fresh subprocess (device count must be set before
JAX initializes).  Writes docs/scaling_data.json.
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

TOTAL_CHANNEL_SAMPLES = 8 * 65536      # fixed total workload (per channel)


def child(n_dev: int):
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    # virtual devices exist only on the CPU backend
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from liquid_usrp_tpu.framing import ofdm, ofdm_sync
    from liquid_usrp_tpu.parallel import stream as pstream
    from liquid_usrp_tpu.parallel.mesh import factor_devices

    t, c = factor_devices(n_dev)
    mesh = jax.make_mesh((t, c), ("time", "channel"),
                         devices=jax.devices()[:n_dev])
    N = 4
    params = ofdm.make_ofdm_params(M=48, cp_len=6, taper_len=4)
    sync = ofdm_sync.make_sync(params, block_size=8192, max_payload=256,
                               max_frames=4)
    # fixed TOTAL workload, split over the mesh (strong scaling shape)
    chunk_blocks = TOTAL_CHANNEL_SAMPLES // (n_dev * sync.block_size)
    run = pstream.make_sharded_mcrx_a2a(mesh, N, sync, chunk_blocks)
    total = 2 * N * TOTAL_CHANNEL_SAMPLES
    rng = np.random.default_rng(0)
    mixture = jnp.asarray(
        (0.1 * (rng.normal(size=total) + 1j * rng.normal(size=total)))
        .astype(np.complex64))
    res = run(mixture)                       # warm up (compile)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(2):
            res = run(mixture)
        best = min(best, (time.perf_counter() - t0) / 2)

    # pipelined super-step form (n_steps>1): same total workload as ONE
    # program — measures the software-pipelined scan (collective/compute
    # overlap shape) against the same 1-device baseline
    n_steps = 4
    cb_pipe = max(1, chunk_blocks // n_steps)
    run_pipe = pstream.make_sharded_mcrx_a2a(mesh, N, sync, cb_pipe,
                                             n_steps=n_steps)
    mix_pipe = mixture[: n_steps * n_dev * 2 * N * cb_pipe
                       * sync.block_size].reshape(n_steps, -1)
    run_pipe(mix_pipe)                       # warm up (compile)
    best_pipe = float("inf")
    pipe_total = mix_pipe.size
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(2):
            run_pipe(mix_pipe)
        best_pipe = min(best_pipe, (time.perf_counter() - t0) / 2)

    # TX dual on the same mesh: sharded synthesis of the same total
    # workload (per-channel baseband -> mixture)
    B_tx = TOTAL_CHANNEL_SAMPLES // n_dev
    run_tx = pstream.make_sharded_mctx(mesh, N, B_tx)
    streams = jnp.asarray(
        (0.1 * (rng.normal(size=(N, TOTAL_CHANNEL_SAMPLES))
                + 1j * rng.normal(size=(N, TOTAL_CHANNEL_SAMPLES))))
        .astype(np.complex64))
    run_tx(streams)                          # warm up (compile)
    best_tx = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(2):
            run_tx(streams)
        best_tx = min(best_tx, (time.perf_counter() - t0) / 2)
    print(json.dumps({
        "n_dev": n_dev, "mesh": [t, c],
        "total_mixture_samples": total, "step_s": best,
        "samples_per_s": total / best,
        "pipe_step_s": best_pipe, "pipe_n_steps": n_steps,
        "pipe_samples_per_s": pipe_total / best_pipe,
        "tx_step_s": best_tx, "tx_samples_per_s": total / best_tx,
    }))


def main():
    if os.environ.get("_SCALE_CHILD"):
        child(int(os.environ["_SCALE_CHILD"]))
        return
    rows = []
    for n in (1, 2, 4, 8):
        env = dict(os.environ, _SCALE_CHILD=str(n))
        out = subprocess.run([sys.executable, os.path.abspath(__file__)],
                             env=env, capture_output=True, text=True,
                             timeout=1200)
        got = False
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                rows.append(json.loads(line))
                print(line)
                got = True
        if not got:
            # a silent child once hid a wrong-backend crash behind stale
            # committed data — fail loudly instead
            print(f"child n_dev={n_dev} produced no result; stderr tail:",
                  file=sys.stderr)
            print(out.stderr[-2000:], file=sys.stderr)
            raise SystemExit(1)
    if rows:
        t1 = rows[0]["step_s"]
        t1_tx = rows[0].get("tx_step_s")
        for r in rows:
            # < ~1.25 keeps the >=80% target reachable once the per-device
            # compute is on independent chips (see docs/scaling.md)
            r["sharding_overhead_vs_1dev"] = round(r["step_s"] / t1, 4)
            if rows[0].get("pipe_step_s") and r.get("pipe_step_s"):
                r["pipe_sharding_overhead_vs_1dev"] = round(
                    r["pipe_step_s"] / rows[0]["pipe_step_s"], 4)
            if t1_tx and r.get("tx_step_s"):
                r["tx_sharding_overhead_vs_1dev"] = round(
                    r["tx_step_s"] / t1_tx, 4)
        import datetime
        sha = subprocess.run(
            ["git", "-C", os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "rev-parse", "--short",
             "HEAD"], capture_output=True, text=True).stdout.strip()
        doc = {"manifest": {"git_sha": sha or "unknown",
                            "utc": datetime.datetime.now(
                                datetime.timezone.utc).isoformat(
                                    timespec="seconds"),
                            "cmd": " ".join(sys.argv)},
               "rows": rows}
        path = os.path.join(os.path.dirname(__file__), "..", "docs",
                            "scaling_data.json")
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        print("overhead:", [r["sharding_overhead_vs_1dev"] for r in rows])


if __name__ == "__main__":
    main()
