"""Multichannel TX -> RX loopback (the multichannel_tx/_rx app pair idiom).

Mirrors the reference's validation: per-channel packets with channel id
stamped in the header (/root/reference/src/multichannel_tx.cc:171-176),
recovered by the per-channel synchronizers
(/root/reference/src/multichannel_rx.cc:37-66).
"""
import numpy as np
import pytest

from liquid_usrp_tpu.models.multichannel import (MultichannelRx,
                                                 MultichannelTx,
                                                 MultichannelTxRx)

N = 2
PAYLOAD = 64


@pytest.fixture(scope="module")
def loopback():
    tx = MultichannelTx(N, M=48, cp_len=6, taper_len=4)
    rx = MultichannelRx(N, M=48, cp_len=6, taper_len=4,
                        block_size=2048, max_payload=128)
    return tx, rx


def test_multichannel_loopback(loopback):
    tx, rx = loopback
    rng = np.random.default_rng(0)
    sent = {}
    for ch in range(N):
        header = rng.integers(0, 256, 8, dtype=np.uint8)
        header[2] = ch  # channel-id stamping idiom (multichannel_tx.cc:174)
        payload = rng.integers(0, 256, PAYLOAD, dtype=np.uint8)
        tx.update_data(ch, header, payload)
        sent[ch] = (header, payload)
    # drain TX: generate enough channel-samples to flush all frames
    need = max(len(q) for q in tx._queues) + 64
    mixture = tx.generate_samples(need)
    assert len(mixture) == 2 * N * need
    frames = rx.execute(mixture)
    frames += rx.flush()
    got = {f["channel"]: f for f in frames if f["payload_valid"]}
    assert set(got.keys()) == set(range(N)), \
        f"valid frames on channels {sorted(got)} only"
    for ch, (header, payload) in sent.items():
        f = got[ch]
        np.testing.assert_array_equal(f["header"], header)
        np.testing.assert_array_equal(f["payload"], payload)


def test_txrx_availability_polling():
    txrx = MultichannelTxRx(N, M=48, cp_len=6, taper_len=4,
                            block_size=2048, max_payload=128)
    rng = np.random.default_rng(1)
    header = rng.integers(0, 256, 8, dtype=np.uint8)
    payload = rng.integers(0, 256, PAYLOAD, dtype=np.uint8)
    assert txrx.is_channel_available(0)
    assert txrx.transmit_packet(0, header, payload)
    assert not txrx.is_channel_available(0)      # busy until drained
    assert txrx.get_available_channel() == 1
    assert not txrx.transmit_packet(0, header, payload)  # non-blocking refuse
    samples = txrx.wait_for_tx_to_complete()
    assert txrx.is_channel_available(0)
    assert len(samples) > 0
    # loop the drained samples back into the receiver
    frames = txrx.rx.execute(samples)
    frames += txrx.rx.flush()
    valid = [f for f in frames if f["payload_valid"] and f["channel"] == 0]
    assert len(valid) == 1
    np.testing.assert_array_equal(valid[0]["payload"], payload)


def test_reference_surface_parity():
    """The small reference-API corners: GetNumChannels/Reset casing,
    radio setters, start_rx gating of run_rx."""
    txrx = MultichannelTxRx(N, M=48, cp_len=6, taper_len=4,
                            block_size=2048, max_payload=128)
    assert txrx.tx.GetNumChannels() == N
    assert txrx.rx.GetNumChannels() == N
    txrx.set_tx_freq(462e6)
    txrx.set_rx_freq(462.1e6)
    txrx.set_tx_antenna("TX/RX")
    assert txrx.radio.rx_freq == 462.1e6
    # RX gate: execute only runs between start_rx/stop_rx
    rng = np.random.default_rng(3)
    header = rng.integers(0, 256, 8, dtype=np.uint8)
    payload = rng.integers(0, 256, PAYLOAD, dtype=np.uint8)
    assert txrx.transmit_packet(0, header, payload)
    samples = txrx.wait_for_tx_to_complete()
    assert txrx.run_rx(samples) == []            # not started
    txrx.start_rx()
    frames = txrx.run_rx(samples) + txrx.rx.flush()
    assert any(f["payload_valid"] for f in frames)
    txrx.stop_rx()
    # Reset drops queued data + carried state without error
    txrx.transmit_packet(1, header, payload)
    txrx.reset_tx()
    assert txrx.is_channel_available(1)
    txrx.reset_rx()
    assert txrx.run_rx(samples) == []            # stopped again


def test_async_tx_worker_ahead_of_cursor():
    """start_worker produces ahead of the consumption cursor on a thread
    (the reference's tx_worker, lib/multichanneltxrx.cc:430-500): the
    ahead-buffer fills while the consumer is idle, stays bounded, and
    packets queued mid-stream come out decodable."""
    import time

    tx = MultichannelTx(N, M=48, cp_len=6, taper_len=4)
    rx = MultichannelRx(N, M=48, cp_len=6, taper_len=4,
                        block_size=2048, max_payload=128)
    rng = np.random.default_rng(7)
    max_ahead = 8192
    tx.start_worker(chunk=128, max_ahead=max_ahead)
    try:
        # producer runs ahead while we do nothing
        deadline = time.time() + 30
        while tx.samples_ahead < max_ahead and time.time() < deadline:
            time.sleep(0.01)
        assert tx.samples_ahead >= max_ahead
        # bounded: one chunk of slack at most
        assert tx.samples_ahead <= max_ahead + 2 * N * 128

        sent = {}
        for ch in range(N):
            header = rng.integers(0, 256, 8, dtype=np.uint8)
            header[2] = ch
            payload = rng.integers(0, 256, PAYLOAD, dtype=np.uint8)
            tx.update_data(ch, header, payload)
            sent[ch] = (header, payload)
        # consume until both queues drained into the produced stream
        chunks = []
        deadline = time.time() + 60
        while (not all(tx.is_channel_ready(c) for c in range(N))
               and time.time() < deadline):
            chunks.append(tx.read_samples(1024))
        assert all(tx.is_channel_ready(c) for c in range(N))
    finally:
        tx.stop_worker()
    # post-stop read tops up synchronously (drain + channelizer flush)
    chunks.append(tx.read_samples(tx.samples_ahead +
                                  2 * N * (2 * tx.chz.P + 64)))
    mixture = np.concatenate(chunks)
    frames = rx.execute(mixture) + rx.flush()
    got = {f["channel"]: f for f in frames if f["payload_valid"]}
    assert set(got.keys()) == set(range(N))
    for ch, (header, payload) in sent.items():
        np.testing.assert_array_equal(got[ch]["header"], header)
        np.testing.assert_array_equal(got[ch]["payload"], payload)


def test_async_worker_read_past_ahead_bound_and_txrx_drain():
    """read_samples(n > max_ahead) must not livelock (the producer parks
    at the bound); wait_for_tx_to_complete with the worker RUNNING
    consumes from the ahead-buffer and still yields decodable air."""
    tx = MultichannelTx(N, M=48, cp_len=6, taper_len=4)
    tx.start_worker(chunk=64, max_ahead=1024)
    try:
        out = tx.read_samples(5000)         # far beyond the ahead bound
        assert len(out) == 5000
    finally:
        tx.stop_worker()

    txrx = MultichannelTxRx(N, M=48, cp_len=6, taper_len=4,
                            block_size=2048, max_payload=128)
    rng = np.random.default_rng(9)
    header = rng.integers(0, 256, 8, dtype=np.uint8)
    payload = rng.integers(0, 256, PAYLOAD, dtype=np.uint8)
    txrx.start_tx(chunk=128, max_ahead=4096)
    try:
        assert txrx.transmit_packet(0, header, payload)
        samples = txrx.wait_for_tx_to_complete()
    finally:
        txrx.stop_tx()
    frames = txrx.rx.execute(samples) + txrx.rx.flush()
    ok = [f for f in frames if f["payload_valid"] and f["channel"] == 0]
    assert len(ok) == 1
    np.testing.assert_array_equal(ok[0]["payload"], payload)


@pytest.mark.slow
def test_mcrx_batched_step_equals_scan():
    """make_mcrx_batched_step == scan of make_mcrx_step on a loaded
    mixture (multi-block dispatch)."""
    import jax
    import jax.numpy as jnp
    from liquid_usrp_tpu.framing import ofdm, ofdm_sync
    from liquid_usrp_tpu.models.multichannel import (
        MultichannelTx, make_mcrx_step, make_mcrx_batched_step)

    N = 2
    params = ofdm.make_ofdm_params(M=48, cp_len=6, taper_len=4)
    sync = ofdm_sync.make_sync(params, block_size=4096, max_payload=128,
                               max_frames=4)
    rng = np.random.default_rng(4)
    tx = MultichannelTx(N, M=48, cp_len=6, taper_len=4)
    n_blocks = 3
    g = 2 * N * sync.block_size
    mix, produced = [], 0
    while produced < n_blocks * g:
        for ch in range(N):
            if tx.is_channel_ready(ch):
                tx.update_data(ch, rng.integers(0, 256, 8, dtype=np.uint8),
                               rng.integers(0, 256, 64, dtype=np.uint8))
        chunk = tx.generate_samples(1024)
        mix.append(chunk)
        produced += len(chunk)
    x = np.concatenate(mix)[: n_blocks * g]
    x = (x + 0.01 * (rng.normal(size=x.shape) +
                     1j * rng.normal(size=x.shape))).astype(np.complex64)

    init_s, step = make_mcrx_step(N, sync)
    init_b, bstep = make_mcrx_batched_step(N, sync, n_blocks)
    st = init_s()
    seq = []
    for b in range(n_blocks):
        st, r = step(st, jnp.asarray(x[b * g:(b + 1) * g]))
        seq.append(jax.tree.map(np.asarray, r))
    st_b, rb = bstep(init_b(), jnp.asarray(x))
    rb = jax.tree.map(np.asarray, rb)          # leaves [N, n_blocks, K,...]
    tot_seq = sum(int(r.payload_valid.sum()) for r in seq)
    assert tot_seq > 0
    assert int(rb.payload_valid.sum()) == tot_seq
    for b in range(n_blocks):
        r = seq[b]
        np.testing.assert_array_equal(rb.detected[:, b], r.detected)
        np.testing.assert_array_equal(rb.t_start[:, b], r.t_start)
        np.testing.assert_array_equal(rb.payload_valid[:, b],
                                      r.payload_valid)
        # payload content contract covers valid rows (invalid rows carry
        # decode garbage that legitimately differs between the per-block
        # and whole-stream window clipping)
        mask = r.payload_valid[..., None]
        np.testing.assert_array_equal(rb.payload[:, b] * mask,
                                      r.payload * mask)
    # carried sync state matches
    np.testing.assert_array_equal(np.asarray(st_b.syncs.tail),
                                  np.asarray(st.syncs.tail))
