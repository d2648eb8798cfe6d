"""Multi-process worker for the distributed TX->RX pipeline test.

One OS process per simulated host (the real topology is one process per
GPU host; here each process exposes N virtual CPU devices via
``xla_force_host_platform_device_count``).  Every process builds the same
deterministic per-channel baseband, contributes its local shards, then
the FULL pipeline runs on the global ``(time, channel)`` mesh: the
sharded transmitter (`make_sharded_mctx`: all_to_all transpose +
fine-time polyphase synthesis with ppermute filter-memory halos)
synthesizes the mixture, and the all-to-all sharded receiver
(`sharded_mcrx`) decodes it — every collective crossing the process
boundary over the Gloo backend, the DCN stand-in.  Results are
allgathered and every injected payload must decode exactly.

Usage: multihost_worker.py <process_id> <num_processes> <port>
(spawned by tests/test_multihost.py with 4 local devices per process).
"""
import sys

import jax

jax.config.update("jax_platforms", "cpu")


def main() -> int:
    pid, n_proc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from liquid_usrp_tpu.parallel import distributed
    distributed.init(coordinator_address=f"localhost:{port}",
                     num_processes=n_proc, process_id=pid)
    assert distributed.is_distributed(), "expected >1 process"
    info = distributed.local_info()
    print(f"pid={pid} {info}", flush=True)

    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from liquid_usrp_tpu.framing import ofdm, ofdm_sync
    from liquid_usrp_tpu.parallel import stream as pstream

    N = 4
    n_dev = len(jax.devices())
    if n_dev % N or n_dev < N:
        raise SystemExit(
            f"need a device count divisible by {N} channel shards per "
            f"process group (got {n_dev} global devices); spawn with "
            f"xla_force_host_platform_device_count a multiple of {N}")
    mesh = jax.make_mesh((n_dev // N, N), ("time", "channel"))
    params = ofdm.make_ofdm_params(48, 6, 4)
    sync = ofdm_sync.make_sync(params, block_size=2048, max_payload=64,
                               max_frames=4)
    chunk_blocks = 1
    B_grp = chunk_blocks * sync.block_size * mesh.shape["channel"]
    total_mix = 2 * N * B_grp * mesh.shape["time"]

    # identical deterministic PER-CHANNEL BASEBAND on every process; the
    # mixture itself is synthesized ON the mesh by the sharded TX, so the
    # whole TX->RX pipeline (all_to_all transpose, synthesis halos,
    # analysis halos, channel reshard) crosses the process boundary
    rng = np.random.default_rng(7)
    T = total_mix // (2 * N)                 # channel-samples
    streams = np.zeros((N, T), np.complex64)
    sent = {}
    for ch in range(N):
        header = rng.integers(0, 256, 8, dtype=np.uint8)
        header[2] = ch
        payload = rng.integers(0, 256, 48, dtype=np.uint8)
        frame = np.asarray(ofdm.assemble_frame(
            params, ofdm.default_props(),
            jax.numpy.asarray(header), jax.numpy.asarray(payload)))
        streams[ch, 100 + 37 * ch:100 + 37 * ch + len(frame)] = frame
        sent[ch] = payload

    tx_run = pstream.make_sharded_mctx(mesh, N, T // n_dev)
    tx_sharding = NamedSharding(mesh, P("channel", "time"))
    global_streams = jax.make_array_from_callback(
        streams.shape, tx_sharding, lambda idx: streams[idx])
    mix3d = tx_run.jit_fn(global_streams)    # [t, c, chunk] sharded
    flatten = jax.jit(lambda a: jax.lax.reshape(
        a, (total_mix,),
        out_sharding=NamedSharding(mesh, P(("time", "channel")))))
    global_in = flatten(mix3d)

    run = pstream.sharded_mcrx(mesh, N, sync, chunk_blocks)
    res = run.jit_fn(global_in)              # sharded across processes
    res = multihost_utils.process_allgather(res, tiled=True)
    res = jax.tree.map(run.regroup, jax.tree.map(np.asarray, res))

    det = res.detected & res.payload_valid
    found = {}
    for ch, r in zip(*np.nonzero(det)):
        found[int(ch)] = np.asarray(res.payload[ch, r])[
            : int(res.payload_len[ch, r])]
    assert set(found) == set(range(N)), sorted(found)
    for ch, payload in sent.items():
        np.testing.assert_array_equal(found[ch], payload)
    print(f"MULTIHOST OK pid={pid} frames={len(found)}", flush=True)
    return 0


if __name__ == "__main__":
    import os
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))
    sys.exit(main())
