"""Reduced-precision IQ ingest (ops/iqfmt): fidelity + pipeline decode.

The RX pipeline does a few FLOPs per input byte, so the receivers accept
a bfloat16-planes mixture ingest.  These tests pin (a) the
quantization-SNR floor of the format and (b) that the full multichannel
pipeline decodes payload-exact from bf16 planes, identically to the
complex64 path.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from liquid_usrp_tpu.framing import ofdm, ofdm_sync
from liquid_usrp_tpu.models.multichannel import MultichannelTx, \
    make_mcrx_step
from liquid_usrp_tpu.ops import iqfmt


def test_bf16_quantization_snr():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=65536) + 1j * rng.normal(size=65536)) \
        .astype(np.complex64)
    back = np.asarray(iqfmt.iq_from_any(iqfmt.iq_to_planes(jnp.asarray(x))))
    err = back - x
    snr_db = 10 * np.log10(np.mean(np.abs(x) ** 2) /
                           np.mean(np.abs(err) ** 2))
    # bf16 has an 8-bit significand: ~45 dB floor, far above any
    # operating channel SNR of the decode chain
    assert snr_db > 40.0, snr_db


def test_sc8_quantization_snr():
    """±127 int8 wire codes: ~40 dB floor for a full-scale-normalized
    stream (the AGC convention of iq_to_planes_sc8)."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=65536) + 1j * rng.normal(size=65536)) \
        .astype(np.complex64)
    x /= np.abs(np.stack([x.real, x.imag])).max()     # AGC to full scale
    back = np.asarray(iqfmt.iq_from_any(iqfmt.iq_to_planes_sc8(
        jnp.asarray(x))))
    err = back - x
    snr_db = 10 * np.log10(np.mean(np.abs(x) ** 2) /
                           np.mean(np.abs(err) ** 2))
    assert snr_db > 35.0, snr_db
    # and the codes really are one byte per plane value
    assert iqfmt.iq_to_planes_sc8(jnp.asarray(x)).dtype == jnp.int8


def test_sc16_planes_dequantize_near_exact():
    """int16 planes at the ±32767 wire convention: > 80 dB — effectively
    transparent, same width as bf16 but more mantissa."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=4096) + 1j * rng.normal(size=4096)) \
        .astype(np.complex64)
    x /= np.abs(np.stack([x.real, x.imag])).max()
    codes = np.clip(np.round(np.stack([x.real, x.imag]) * 32767.0),
                    -32767, 32767).astype(np.int16)
    back = np.asarray(iqfmt.iq_from_any(jnp.asarray(codes)))
    err = back - x
    snr_db = 10 * np.log10(np.mean(np.abs(x) ** 2) /
                           np.mean(np.abs(err) ** 2))
    assert snr_db > 80.0, snr_db


def test_sc8_file_roundtrip(tmp_path):
    """.sc8 files (UHD sc8 wire mode twin) round-trip within one code."""
    from liquid_usrp_tpu.io import streams
    rng = np.random.default_rng(6)
    x = (rng.uniform(-0.9, 0.9, 512) +
         1j * rng.uniform(-0.9, 0.9, 512)).astype(np.complex64)
    p = str(tmp_path / "a.sc8")
    streams.write_iq(p, x)
    import os
    assert os.path.getsize(p) == 2 * 512          # 2 B/sample on disk
    np.testing.assert_allclose(streams.read_iq(p), x, atol=1.5 / 127)


def test_iq_from_any_passthrough_and_validation():
    x = jnp.asarray(np.array([1 + 2j, 3 - 1j], np.complex64))
    np.testing.assert_array_equal(np.asarray(iqfmt.iq_from_any(x)),
                                  np.asarray(x))
    try:
        iqfmt.iq_from_any(jnp.zeros((3, 4), jnp.float32))
    except ValueError:
        pass
    else:  # pragma: no cover
        raise AssertionError("bad plane shape accepted")
    try:
        iqfmt.iq_from_any(jnp.zeros((2, 4), jnp.int32))
    except ValueError:
        pass
    else:  # pragma: no cover
        raise AssertionError("int32 planes accepted without a convention")


def test_mcrx_decodes_from_bf16_planes():
    """Full pipeline over bf16 planes == complex64 path, payload-exact."""
    N = 2
    params = ofdm.make_ofdm_params(M=48, cp_len=6, taper_len=4)
    sync = ofdm_sync.make_sync(params, block_size=4096, max_payload=128,
                               max_frames=4)
    rng = np.random.default_rng(5)
    tx = MultichannelTx(N, M=48, cp_len=6, taper_len=4)
    sent = {}
    for ch in range(N):
        header = rng.integers(0, 256, 8, dtype=np.uint8)
        header[2] = ch
        payload = rng.integers(0, 256, 64, dtype=np.uint8)
        tx.update_data(ch, header, payload)
        sent[ch] = payload
    n_blocks = 3
    g = 2 * N * sync.block_size
    x = np.asarray(tx.generate_samples(n_blocks * g // (2 * N)))
    x = (x + 0.01 * (rng.normal(size=x.shape) +
                     1j * rng.normal(size=x.shape))).astype(np.complex64)

    init_state, step = make_mcrx_step(N, sync)

    def run(blocks_iter):
        st = init_state()
        out = []
        for blk in blocks_iter:
            st, r = step(st, blk)
            out.append(jax.tree.map(np.asarray, r))
        return out

    c64_blocks = [jnp.asarray(x[b * g:(b + 1) * g])
                  for b in range(n_blocks)]
    bf16_blocks = [iqfmt.iq_to_planes(b) for b in c64_blocks]
    peak = float(np.abs(np.stack([x.real, x.imag])).max())
    sc8_blocks = [iqfmt.iq_to_planes_sc8(b / peak)     # AGC to full scale
                  for b in c64_blocks]
    res_c, res_b = run(c64_blocks), run(bf16_blocks)
    res_s = run(sc8_blocks)

    def recovered(rs):
        got = {}
        for r in rs:
            for ch in range(N):
                for k in range(sync.max_frames):
                    if r.payload_valid[ch, k]:
                        got[ch] = r.payload[ch, k][
                            : int(r.payload_len[ch, k])]
        return got

    for res in (res_b, res_s):                 # bf16 AND sc8 payload-exact
        got = recovered(res)
        assert set(got) == set(range(N)), sorted(got)
        for ch, payload in sent.items():
            np.testing.assert_array_equal(got[ch], payload)
    # same frames recovered as the complex64 path
    tot = lambda rs: sum(int(r.payload_valid.sum()) for r in rs)  # noqa:E731
    assert tot(res_b) == tot(res_c) > 0
    assert tot(res_s) == tot(res_c)


def test_a2a_sharded_mcrx_bf16_ingest():
    """The all-to-all sharded receiver decodes from sharded bf16 planes
    (plane axis replicated, sample axis over the flat mesh)."""
    from liquid_usrp_tpu.parallel import stream as pstream

    N = 4
    mesh = jax.make_mesh((2, 4), ("time", "channel"))
    params = ofdm.make_ofdm_params(M=48, cp_len=6, taper_len=4)
    sync = ofdm_sync.make_sync(params, block_size=2048, max_payload=64,
                               max_frames=4)
    chunk_blocks = 1
    B_grp = chunk_blocks * sync.block_size * 4
    total_mix = 2 * N * B_grp * 2            # two time rows

    tx = MultichannelTx(N, M=48, cp_len=6, taper_len=4)
    rng = np.random.default_rng(9)
    sent = {}
    for ch in range(N):
        header = rng.integers(0, 256, 8, dtype=np.uint8)
        header[2] = ch
        payload = rng.integers(0, 256, 48, dtype=np.uint8)
        tx.update_data(ch, header, payload)
        sent[ch] = payload
    mixture = jnp.asarray(tx.generate_samples(total_mix // (2 * N)))

    run = pstream.make_sharded_mcrx_a2a(mesh, N, sync, chunk_blocks,
                                        ingest="bf16")
    res = run(iqfmt.iq_to_planes(mixture))
    det = res.detected & res.payload_valid
    found = {}
    for ch, r in zip(*np.nonzero(det)):
        found[int(ch)] = np.asarray(res.payload[ch, r])[
            : int(res.payload_len[ch, r])]
    assert set(found) == set(range(N)), sorted(found)
    for ch, payload in sent.items():
        np.testing.assert_array_equal(found[ch], payload)


@pytest.mark.slow
def test_flex_and_gmsk_sync_accept_planes():
    """All frame families accept the [2, bs] plane ingest."""
    from liquid_usrp_tpu.framing import flexframe as ff
    from liquid_usrp_tpu.framing import flexframe_sync as ffs
    from liquid_usrp_tpu.framing import gmskframe as gf

    rng = np.random.default_rng(11)

    def drive(make_burst, sync, init, block_fn):
        header = rng.integers(0, 256, getattr(sync, "header_user", 8),
                              dtype=np.uint8)
        payload = rng.integers(0, 256, 64, dtype=np.uint8)
        burst = np.asarray(make_burst(header, payload))
        stream = np.zeros(2 * sync.block_size, np.complex64)
        stream[1000:1000 + len(burst)] = burst
        st = init(sync)
        got = 0
        for b in range(2 + sync.overlap // sync.block_size + 1):
            lo = (b % 2) * sync.block_size
            blk = stream[lo:lo + sync.block_size] if b < 2 else \
                np.zeros(sync.block_size, np.complex64)
            st, r = block_fn(sync, st, iqfmt.iq_to_planes(jnp.asarray(blk)))
            for k in range(sync.max_frames):
                if r.payload_valid[k]:
                    got += 1
                    np.testing.assert_array_equal(
                        np.asarray(r.payload[k])[: int(r.payload_len[k])],
                        payload)
        assert got == 1

    fparams = ff.make_flex_params()
    fsync = ffs.make_flex_sync(fparams, block_size=8192, max_payload=128,
                               max_frames=4)
    drive(lambda h, p: ff.flex_assemble(fparams, ff.default_props(),
                                        jnp.asarray(h), jnp.asarray(p)),
          fsync, ffs.flex_sync_init, ffs.flex_sync_block)

    gparams = gf.make_gmsk_params()
    gsync = gf.make_gmsk_sync(gparams, block_size=8192, max_payload=128,
                              max_frames=4)
    drive(lambda h, p: gf.gmsk_assemble(gparams, gf.gmsk_default_props(),
                                        jnp.asarray(h), jnp.asarray(p)),
          gsync, gf.gmsk_sync_init, gf.gmsk_sync_block)
