"""Example: the all-to-all sharded multichannel receiver on a device mesh.

Runs on any mesh — 8 virtual CPU devices here so it works everywhere:

  python examples/multichip_sharded_rx_example.py

On a multi-GPU host, drop the host-count flag and build the mesh over
jax.devices(); the same code runs over NVLink (see docs/scaling.md).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")
# a virtual-device mesh exists only on the CPU backend
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from liquid_usrp_tpu.framing import ofdm, ofdm_sync  # noqa: E402
from liquid_usrp_tpu.models.multichannel import MultichannelTx  # noqa: E402
from liquid_usrp_tpu.parallel import stream as pstream  # noqa: E402

mesh = jax.make_mesh((2, 4), ("time", "channel"))
N = 4
params = ofdm.make_ofdm_params(M=48, cp_len=6, taper_len=4)
sync = ofdm_sync.make_sync(params, block_size=2048, max_payload=64,
                           max_frames=4)

# one frame per channel through the synthesis filterbank
tx = MultichannelTx(N, M=48, cp_len=6, taper_len=4)
rng = np.random.default_rng(0)
sent = {}
for ch in range(N):
    header = np.zeros(8, np.uint8)
    header[2] = ch
    payload = rng.integers(0, 256, 48, dtype=np.uint8)
    tx.update_data(ch, header, payload)
    sent[ch] = payload
chunk_blocks = 1
total = 2 * N * (chunk_blocks * sync.block_size * 4) * 2
mixture = tx.generate_samples(total // (2 * N))

# the default sharded receiver: every device channelizes distinct samples,
# one all_to_all reshards channelizer output -> per-channel streams
run = pstream.sharded_mcrx(mesh, N, sync, chunk_blocks)
res = jax.tree.map(np.asarray, run(jnp.asarray(mixture)))

ok = 0
for ch, r in zip(*np.nonzero(res.detected & res.payload_valid)):
    got = res.payload[ch, r][: int(res.payload_len[ch, r])]
    match = np.array_equal(got, sent[int(ch)])
    ok += match
    print(f"channel {ch}: payload "
          f"{'matches' if match else 'MISMATCH'} "
          f"({int(res.payload_len[ch, r])} bytes)")
print(f"{ok}/{N} channels decoded payload-exact on a "
      f"{mesh.shape['time']}x{mesh.shape['channel']} mesh")
