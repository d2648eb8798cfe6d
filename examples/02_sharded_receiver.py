"""Device-mesh sharding of the multichannel pipeline (8 virtual devices).

    python examples/02_sharded_receiver.py

Demonstrates the device-mesh scaling story on a CPU-simulated mesh:
* ``make_sharded_mctx``     — per-channel TX baseband sharded over the
  ``channel`` axis, ``all_to_all`` transpose, fine-time-sharded polyphase
  synthesis (the reference's multichanneltx, scaled out).
* ``sharded_mcrx`` (a2a)    — every device channelizes distinct time
  chunks, one ``all_to_all`` reshards to per-channel streams, each device
  runs the synchronizers for its channel subset.
On real GPUs the same code runs over NVLink; only the mesh changes.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")
# a virtual-device mesh exists only on the CPU backend
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np                                            # noqa: E402

import jax                                                    # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp                                       # noqa: E402

from liquid_usrp_tpu.framing import ofdm, ofdm_sync           # noqa: E402
from liquid_usrp_tpu.parallel import stream as pstream        # noqa: E402


def main():
    mesh = jax.make_mesh((2, 4), ("time", "channel"))
    N = 4
    params = ofdm.make_ofdm_params(M=48, cp_len=6, taper_len=4)
    sync = ofdm_sync.make_sync(params, block_size=4096, max_payload=128,
                               max_frames=4)
    chunk_blocks = -(-sync.overlap // (sync.block_size * 4)) + 1
    B = chunk_blocks * sync.block_size      # channel-samples per fine chunk
    T = 2 * 4 * B                           # total channel-samples

    # per-channel baseband: one frame on every channel
    rng = np.random.default_rng(0)
    sent = {}
    streams = np.zeros((N, T), np.complex64)
    for ch in range(N):
        header = rng.integers(0, 256, 8, dtype=np.uint8)
        payload = rng.integers(0, 256, 64, dtype=np.uint8)
        f = np.asarray(ofdm.assemble_frame(
            params, ofdm.default_props(), jnp.asarray(header),
            jnp.asarray(payload)))
        pos = 500 + ch * 997
        streams[ch, pos:pos + len(f)] = f
        sent[ch] = payload

    # sharded synthesis -> one mixture, then sharded receive
    tx = pstream.make_sharded_mctx(mesh, N, B)
    mixture = tx(jnp.asarray(streams))
    print(f"synthesized {mixture.shape[0]} mixture samples on the mesh")

    rx = pstream.sharded_mcrx(mesh, N, sync, chunk_blocks)
    res = rx(jnp.asarray(mixture))
    got = 0
    for ch in range(N):
        det = np.nonzero(np.asarray(res.payload_valid[ch]))[0]
        for i in det:
            p = np.asarray(res.payload[ch, i])[
                : int(res.payload_len[ch, i])]
            assert np.array_equal(p, sent[ch]), ch
            got += 1
    print(f"recovered {got}/{N} per-channel payloads exactly")
    assert got == N
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
