"""Software-pipelined streaming on the device mesh (8 virtual devices).

    python examples/04_pipelined_streaming.py

The sharded all-to-all receiver as a *streaming* pipeline:
``make_sharded_mcrx_a2a(..., n_steps=k)`` processes k super-steps of the
mixture as ONE compiled ``lax.scan`` whose iteration body runs
super-step i's channelize + ``all_to_all`` alongside super-step i-1's
frame sync.  The two halves share no data, so on real devices XLA's
latency-hiding scheduler can run the collective behind the sync compute
(docs/scaling.md "overlapped a2a").  Filter memory, NCO phase and sync
overlap carry across super-steps exactly — frames straddling super-step
boundaries decode identically to the one-shot receiver.
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
from liquid_usrp_tpu.models.multichannel import make_mctx_step  # noqa: E402
from liquid_usrp_tpu.parallel import stream as pstream        # noqa: E402


def main():
    N = 4                                   # channels
    n_steps, chunk_blocks = 3, 1
    mesh = jax.make_mesh((2, 4), ("time", "channel"))
    params = ofdm.make_ofdm_params(M=48, cp_len=6, taper_len=4)
    sync = ofdm_sync.make_sync(params, block_size=2048, max_payload=64,
                               max_frames=4)
    n_dev = 8
    step_csamp = n_dev * chunk_blocks * sync.block_size
    T = n_steps * step_csamp

    # per-channel frames, deliberately straddling the super-step seams
    props = ofdm.default_props()
    flen = ofdm.frame_length(params, props, 40)
    rng = np.random.default_rng(1)
    sent = 0
    streams = np.zeros((T, N), np.complex64)
    for ch in range(N):
        for pos in (2000, step_csamp - flen // 2,
                    2 * step_csamp - flen // 2):
            h = rng.integers(0, 256, 8, dtype=np.uint8)
            p = rng.integers(0, 256, 40, dtype=np.uint8)
            streams[pos:pos + flen, ch] = np.asarray(ofdm.assemble_frame(
                params, props, jnp.asarray(h), jnp.asarray(p)))
            sent += 1

    # synthesize the centered 2N-channel mixture (the multichanneltx dual)
    init, step = make_mctx_step(N)
    st, out = init(), []
    for lo in range(0, T, 1 << 14):
        Y = np.zeros((1 << 14, 2 * N), np.complex64)
        Y[:, :N] = streams[lo:lo + (1 << 14)]
        st, y = step(st, jnp.asarray(Y))
        out.append(np.asarray(y))
    mixture = np.concatenate(out)

    run = pstream.make_sharded_mcrx_a2a(mesh, N, sync, chunk_blocks,
                                        n_steps=n_steps)
    res = run(jnp.asarray(mixture.reshape(n_steps, -1)))
    ok = np.asarray(res.detected & res.payload_valid)
    print(f"devices: {n_dev}  mesh: {dict(zip(mesh.axis_names, mesh.shape.values()))}")
    print(f"super-steps: {n_steps}  (a2a of step i overlaps sync of i-1)")
    print(f"frames sent {sent}, decoded payload-exact {int(ok.sum())}")
    assert int(ok.sum()) == sent
    print("OK")


if __name__ == "__main__":
    main()
