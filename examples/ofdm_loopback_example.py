"""Example: end-to-end OFDM TX -> impaired channel -> synchronizer loopback.

Run: JAX_PLATFORMS=cpu python examples/ofdm_loopback_example.py
(or on the GPU by omitting the env var)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import jax.numpy as jnp

from liquid_usrp_tpu.framing import ofdm, ofdm_sync
from liquid_usrp_tpu.io import channel_model as chan
from liquid_usrp_tpu.ops import modem, fec, crc

params = ofdm.make_ofdm_params(M=48, cp_len=6, taper_len=4)
props = ofdm.FrameProps(check=crc.CRC_32, fec0=fec.FEC_NONE,
                        fec1=fec.FEC_GOLAY2412, mod=modem.MOD_QPSK)
rng = np.random.default_rng(0)
payload_len = 200
header = jnp.asarray(rng.integers(0, 256, 8, dtype=np.uint8))
payload = jnp.asarray(rng.integers(0, 256, payload_len, dtype=np.uint8))

frame = ofdm.assemble_frame(params, props, header, payload)
print("frame len:", frame.shape, "power:", float(jnp.mean(jnp.abs(frame)**2)))

sync = ofdm_sync.make_sync(params, block_size=8192, max_payload=512,
                           max_frames=4)
print("overlap:", sync.overlap, "max_psym:", sync.max_psym)

# place the frame in a stream with some silence
stream = np.zeros(8192 * 5, dtype=np.complex64)
start = 1000
stream[start:start + len(frame)] = np.asarray(frame)
ch = chan.Channel(snr_db=25.0, cfo=0.001, phase=0.7, delay=0)
key = jax.random.PRNGKey(1)
stream = np.asarray(chan.channel_apply(ch, key, jnp.asarray(stream),
                                       signal_power=0.8))

step = ofdm_sync.make_sync_step(sync)
state = ofdm_sync.sync_init(sync)
for b in range(5):
    blk = jnp.asarray(stream[b * 8192:(b + 1) * 8192])
    state, res = step(state, blk)
    det = np.asarray(res.detected)
    for i in range(sync.max_frames):
        if det[i]:
            print(f"block {b} cand {i}: t={int(res.t_start[i])} "
                  f"hdr_ok={bool(res.header_valid[i])} "
                  f"pay_ok={bool(res.payload_valid[i])} "
                  f"plen={int(res.payload_len[i])} "
                  f"rssi={float(res.rssi[i]):.1f} evm={float(res.evm[i]):.1f} "
                  f"cfo={float(res.cfo[i]):.5f}")
            if bool(res.header_valid[i]):
                hdr = np.asarray(res.header[i])
                print("  header match:", np.array_equal(hdr, np.asarray(header)))
            if bool(res.payload_valid[i]):
                pl = np.asarray(res.payload[i])[:payload_len]
                print("  payload match:", np.array_equal(pl, np.asarray(payload)))
