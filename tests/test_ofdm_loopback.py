"""OFDM flexframe TX -> impairment channel -> sync loopback tests.

The deterministic replacement for the reference's paired over-the-air apps
(ofdmflexframe_tx / ofdmflexframe_rx, SURVEY.md §4): assert payload-exact
recovery through AWGN/CFO/phase/delay channels, across payload mod/FEC
combinations, with multiple frames per stream and block-size invariance.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from liquid_usrp_tpu.framing import ofdm, ofdm_sync
from liquid_usrp_tpu.io import channel_model as chan
from liquid_usrp_tpu.ops import crc, fec, modem

M, CP, TAPER = 48, 6, 4
BLOCK = 8192


@pytest.fixture(scope="module")
def setup():
    params = ofdm.make_ofdm_params(M=M, cp_len=CP, taper_len=TAPER)
    sync = ofdm_sync.make_sync(params, block_size=BLOCK, max_payload=512,
                               max_frames=4)
    step = ofdm_sync.make_sync_step(sync)
    return params, sync, step


def _run_stream(sync, step, stream):
    """Feed a stream through the synchronizer; collect detected frames."""
    bs = sync.block_size
    n_blocks = -(-len(stream) // bs)
    pad = n_blocks * bs - len(stream)
    stream = np.concatenate([stream, np.zeros(pad, np.complex64)])
    # extra flush blocks so late frames clear the overlap delay
    flush = int(np.ceil(sync.overlap / bs)) + 1
    stream = np.concatenate(
        [stream, np.zeros(flush * bs, np.complex64)])
    state = ofdm_sync.sync_init(sync)
    frames = []
    for b in range((len(stream)) // bs):
        state, res = step(state, jnp.asarray(stream[b * bs:(b + 1) * bs]))
        det = np.asarray(res.detected)
        for i in np.nonzero(det)[0]:
            frames.append({
                "t": int(res.t_start[i]),
                "header_valid": bool(res.header_valid[i]),
                "payload_valid": bool(res.payload_valid[i]),
                "header": np.asarray(res.header[i]),
                "payload": np.asarray(res.payload[i]),
                "payload_len": int(res.payload_len[i]),
                "evm": float(res.evm[i]),
                "cfo": float(res.cfo[i]),
                "rssi": float(res.rssi[i]),
            })
    return sorted(frames, key=lambda f: f["t"])


def _make_frame(params, props, seed, payload_len):
    rng = np.random.default_rng(seed)
    header = rng.integers(0, 256, ofdm.HEADER_USER_BYTES, dtype=np.uint8)
    payload = rng.integers(0, 256, payload_len, dtype=np.uint8)
    samples = np.asarray(ofdm.assemble_frame(
        params, props, jnp.asarray(header), jnp.asarray(payload)))
    return header, payload, samples


def test_single_frame_clean(setup):
    params, sync, step = setup
    props = ofdm.FrameProps()
    header, payload, samples = _make_frame(params, props, 1, 256)
    stream = np.zeros(4000 + len(samples), np.complex64)
    stream[1500:1500 + len(samples)] = samples
    frames = _run_stream(sync, step, stream)
    assert len(frames) == 1
    f = frames[0]
    assert f["header_valid"] and f["payload_valid"]
    assert f["t"] == 1500
    np.testing.assert_array_equal(f["header"], header)
    np.testing.assert_array_equal(f["payload"][:256], payload)
    assert f["payload_len"] == 256


@pytest.mark.parametrize("mod,fec0,fec1,check", [
    (modem.MOD_QPSK, fec.FEC_NONE, fec.FEC_GOLAY2412, crc.CRC_32),
    (modem.MOD_QPSK, fec.FEC_NONE, fec.FEC_HAMMING128, crc.CRC_32),
    (modem.MOD_QAM16, fec.FEC_HAMMING74, fec.FEC_NONE, crc.CRC_16),
    (modem.MOD_PSK8, fec.FEC_NONE, fec.FEC_SECDED2216, crc.CRC_32),
    (modem.MOD_QAM64, fec.FEC_NONE, fec.FEC_GOLAY2412, crc.CRC_32),
    (modem.MOD_BPSK, fec.FEC_REP3, fec.FEC_NONE, crc.CRC_16),
])
def test_props_matrix_awgn(setup, mod, fec0, fec1, check):
    """Per-packet runtime-selected mod/FEC decode (the ofdmflexframegen
    setprops surface) through a 25 dB AWGN + CFO channel."""
    params, sync, step = setup
    props = ofdm.FrameProps(check=check, fec0=fec0, fec1=fec1, mod=mod)
    header, payload, samples = _make_frame(params, props, mod * 7 + fec1, 120)
    stream = np.zeros(3000 + len(samples), np.complex64)
    stream[800:800 + len(samples)] = samples
    ch = chan.Channel(snr_db=25.0, cfo=0.002, phase=1.1)
    stream = np.asarray(chan.channel_apply(
        ch, jax.random.PRNGKey(mod), jnp.asarray(stream), signal_power=0.8))
    frames = _run_stream(sync, step, stream)
    assert len(frames) == 1, f"{len(frames)} detections"
    f = frames[0]
    assert f["header_valid"], "header failed"
    assert f["payload_valid"], "payload failed"
    np.testing.assert_array_equal(f["payload"][:120], payload)


def test_multiple_frames_stream(setup):
    """Several back-to-back frames with different payloads (TX loop shape of
    /root/reference/src/ofdmflexframe_tx.cc:128-145)."""
    params, sync, step = setup
    props = ofdm.FrameProps()
    stream = np.zeros(40000, np.complex64)
    sent = []
    pos = 700
    for pid in range(5):
        header, payload, samples = _make_frame(params, props, 100 + pid, 200)
        header[0] = pid  # pid stamping idiom (ofdmflexframe_tx.cc:133-136)
        samples = np.asarray(ofdm.assemble_frame(
            params, props, jnp.asarray(header), jnp.asarray(payload)))
        stream[pos:pos + len(samples)] = samples
        sent.append((pos, header, payload))
        pos += len(samples) + 900
    ch = chan.Channel(snr_db=30.0)
    stream = np.asarray(chan.channel_apply(
        ch, jax.random.PRNGKey(7), jnp.asarray(stream), signal_power=0.8))
    frames = _run_stream(sync, step, stream)
    assert len(frames) == 5
    for f, (pos, header, payload) in zip(frames, sent):
        assert f["payload_valid"]
        assert abs(f["t"] - pos) <= 2
        np.testing.assert_array_equal(f["header"], header)
        np.testing.assert_array_equal(f["payload"][:200], payload)


def test_delay_and_cfo(setup):
    """Unknown integer delay + strong CFO + phase: timing recovery must not
    depend on block alignment."""
    params, sync, step = setup
    props = ofdm.FrameProps()
    header, payload, samples = _make_frame(params, props, 55, 300)
    stream = np.zeros(2000 + len(samples), np.complex64)
    stream[137:137 + len(samples)] = samples
    ch = chan.Channel(snr_db=22.0, cfo=0.01, phase=2.0, delay=251)
    stream = np.asarray(chan.channel_apply(
        ch, jax.random.PRNGKey(3), jnp.asarray(stream), signal_power=0.8))
    frames = _run_stream(sync, step, stream)
    assert len(frames) == 1
    f = frames[0]
    assert f["payload_valid"]
    assert abs(f["t"] - (137 + 251)) <= 2
    np.testing.assert_allclose(f["cfo"], 0.01, atol=1.5e-3)
    np.testing.assert_array_equal(f["payload"][:300], payload)


def test_block_size_invariance(setup):
    """The same stream chopped at different block sizes yields the same
    frames (SURVEY.md §7 hard part 2)."""
    params, _, _ = setup
    props = ofdm.FrameProps()
    header, payload, samples = _make_frame(params, props, 77, 180)
    base = np.zeros(30000, np.complex64)
    base[4321:4321 + len(samples)] = samples
    ch = chan.Channel(snr_db=28.0, cfo=0.003)
    base = np.asarray(chan.channel_apply(
        ch, jax.random.PRNGKey(9), jnp.asarray(base), signal_power=0.8))
    results = []
    for bs in (8192, 4096):
        s = ofdm_sync.make_sync(params, block_size=bs, max_payload=512,
                                max_frames=4)
        st = ofdm_sync.make_sync_step(s)
        frames = _run_stream(s, st, base)
        results.append(frames)
    assert len(results[0]) == len(results[1]) == 1
    a, b = results[0][0], results[1][0]
    assert a["t"] == b["t"]
    np.testing.assert_array_equal(a["payload"], b["payload"])


def test_low_snr_detection_sensitivity(setup):
    """The segmented-coherent S0 cross-correlation detector must hold
    frame detection at 2 dB SNR — where the Schmidl-Cox autocorrelation
    metric detected 11/40 (docs/ber_ofdm_v27_soft pre-round-3; 40/40
    now).  Pinned so a detector change can't silently give the ~3 dB
    back."""
    params, sync, step = setup
    props = ofdm.FrameProps()
    header, payload, samples = _make_frame(params, props, 21, 200)
    sig = float(np.mean(np.abs(samples) ** 2))
    hits = 0
    for seed in range(5):
        stream = np.zeros(3500 + len(samples), np.complex64)
        pos = 700 + 500 * seed
        stream[pos:pos + len(samples)] = samples
        noisy = np.asarray(chan.channel_apply(
            chan.Channel(snr_db=2.0, cfo=0.001), jax.random.PRNGKey(seed),
            jnp.asarray(stream), signal_power=sig))
        frames = _run_stream(sync, step, noisy)
        hits += any(abs(f["t"] - pos) <= params.M // 2 for f in frames)
    assert hits == 5, hits


@pytest.mark.parametrize("geom", [(12, 2, 1), (16, 4, 2), (64, 8, 4)])
def test_xcorr_detector_across_geometries(geom):
    """The S0 cross-correlation detector must cover every M: its
    coherence-segment length adapts to a divisor of NUM_S0*M (a fixed
    24 would leave zero segments at M<12 and uncovered template samples
    at M=64 — found in review)."""
    Mg, cpg, tpg = geom
    params = ofdm.make_ofdm_params(M=Mg, cp_len=cpg, taper_len=tpg)
    sync = ofdm_sync.make_sync(params, block_size=4096, max_payload=64,
                               max_frames=2)
    step = ofdm_sync.make_sync_step(sync)
    rng = np.random.default_rng(Mg)
    header = rng.integers(0, 256, 8, dtype=np.uint8)
    payload = rng.integers(0, 256, 40, dtype=np.uint8)
    samples = np.asarray(ofdm.assemble_frame(
        params, ofdm.FrameProps(), jnp.asarray(header),
        jnp.asarray(payload)))
    stream = np.zeros(2500 + len(samples), np.complex64)
    stream[900:900 + len(samples)] = samples
    frames = _run_stream(sync, step, stream)
    ok = [f for f in frames if f["payload_valid"]]
    assert len(ok) == 1 and ok[0]["t"] == 900, frames
    np.testing.assert_array_equal(ok[0]["payload"][:40], payload)


def test_low_snr_header_rejection(setup):
    """At very low SNR the CRC gates must reject corrupt payloads rather
    than return garbage as valid."""
    params, sync, step = setup
    props = ofdm.FrameProps(fec1=fec.FEC_NONE)
    header, payload, samples = _make_frame(params, props, 11, 400)
    stream = np.zeros(2000 + len(samples), np.complex64)
    stream[600:600 + len(samples)] = samples
    ch = chan.Channel(snr_db=2.0)
    stream = np.asarray(chan.channel_apply(
        ch, jax.random.PRNGKey(5), jnp.asarray(stream), signal_power=0.8))
    frames = _run_stream(sync, step, stream)
    for f in frames:
        if not f["header_valid"]:
            continue
        if f["payload_valid"]:
            np.testing.assert_array_equal(f["payload"][:400], payload)


def test_conv_payload_decode():
    """Runtime Viterbi payload decode (enable_conv sync): the reference CLI
    offers conv codes through its FEC parser for any packet."""
    params = ofdm.make_ofdm_params(M=M, cp_len=CP, taper_len=TAPER)
    sync = ofdm_sync.make_sync(params, block_size=4096, max_payload=64,
                               max_frames=2, enable_conv=True)
    step = ofdm_sync.make_sync_step(sync)
    props = ofdm.FrameProps(check=crc.CRC_32, fec0=fec.FEC_CONV_V27,
                            fec1=fec.FEC_NONE, mod=modem.MOD_QPSK)
    header, payload, samples = _make_frame(params, props, 3, 48)
    stream = np.zeros(2000 + len(samples), np.complex64)
    stream[700:700 + len(samples)] = samples
    ch = chan.Channel(snr_db=12.0)
    stream = np.asarray(chan.channel_apply(
        ch, jax.random.PRNGKey(2), jnp.asarray(stream), signal_power=0.8))
    frames = _run_stream(sync, step, stream)
    ok = [f for f in frames if f["payload_valid"]]
    assert len(ok) == 1, frames
    np.testing.assert_array_equal(ok[0]["payload"][:48], payload)


def test_rs8_payload_decode():
    """Runtime RS(255,223) payload decode through the extended FEC switch."""
    params = ofdm.make_ofdm_params(M=M, cp_len=CP, taper_len=TAPER)
    sync = ofdm_sync.make_sync(params, block_size=4096, max_payload=64,
                               max_frames=2, enable_conv=True)
    step = ofdm_sync.make_sync_step(sync)
    props = ofdm.FrameProps(check=crc.CRC_32, fec0=fec.FEC_NONE,
                            fec1=fec.FEC_RS8, mod=modem.MOD_QPSK)
    header, payload, samples = _make_frame(params, props, 4, 48)
    stream = np.zeros(2000 + len(samples), np.complex64)
    stream[700:700 + len(samples)] = samples
    ch = chan.Channel(snr_db=15.0)
    stream = np.asarray(chan.channel_apply(
        ch, jax.random.PRNGKey(6), jnp.asarray(stream), signal_power=0.8))
    frames = _run_stream(sync, step, stream)
    ok = [f for f in frames if f["payload_valid"]]
    assert len(ok) == 1, frames
    np.testing.assert_array_equal(ok[0]["payload"][:48], payload)


def test_soft_conv_payload_low_snr():
    """Soft-decision sync (LLRs into the Viterbi branch) decodes conv
    payloads end-to-end.  (The fixed h128 header limits the observable
    range to ~8 dB+; the soft-vs-hard superiority itself is demonstrated at
    the decoder level in test_fec.py::test_soft_viterbi_beats_hard.)"""
    params = ofdm.make_ofdm_params(M=M, cp_len=CP, taper_len=TAPER)
    sync = ofdm_sync.make_sync(params, block_size=4096, max_payload=64,
                               max_frames=2, enable_conv=True, soft=True)
    step = ofdm_sync.make_sync_step(sync)
    props = ofdm.FrameProps(check=crc.CRC_32, fec0=fec.FEC_CONV_V27,
                            fec1=fec.FEC_NONE, mod=modem.MOD_QPSK)
    header, payload, samples = _make_frame(params, props, 9, 48)
    stream = np.zeros(2000 + len(samples), np.complex64)
    stream[700:700 + len(samples)] = samples
    ch = chan.Channel(snr_db=10.0)
    stream = np.asarray(chan.channel_apply(
        ch, jax.random.PRNGKey(11), jnp.asarray(stream), signal_power=0.8))
    frames = _run_stream(sync, step, stream)
    ok = [f for f in frames if f["payload_valid"]]
    assert len(ok) == 1, frames
    np.testing.assert_array_equal(ok[0]["payload"][:48], payload)


def test_multipath_channel(setup):
    """Two-tap multipath: the S1-based equalizer must absorb static ISI."""
    params, sync, step = setup
    props = ofdm.FrameProps()
    header, payload, samples = _make_frame(params, props, 21, 200)
    stream = np.zeros(3000 + len(samples), np.complex64)
    stream[900:900 + len(samples)] = samples
    ch = chan.Channel(snr_db=25.0, multipath=(1.0, 0.25 + 0.15j))
    stream = np.asarray(chan.channel_apply(
        ch, jax.random.PRNGKey(21), jnp.asarray(stream), signal_power=0.8))
    frames = _run_stream(sync, step, stream)
    ok = [f for f in frames if f["payload_valid"]]
    assert len(ok) == 1
    np.testing.assert_array_equal(ok[0]["payload"][:200], payload)


def test_sample_rate_offset(setup):
    """50 ppm clock skew: pilot timing-slope tracking must hold the frame."""
    params, sync, step = setup
    props = ofdm.FrameProps()
    header, payload, samples = _make_frame(params, props, 22, 200)
    stream = np.zeros(3000 + len(samples), np.complex64)
    stream[900:900 + len(samples)] = samples
    ch = chan.Channel(snr_db=28.0, sro_ppm=50.0)
    stream = np.asarray(chan.channel_apply(
        ch, jax.random.PRNGKey(22), jnp.asarray(stream), signal_power=0.8))
    frames = _run_stream(sync, step, stream)
    ok = [f for f in frames if f["payload_valid"]]
    assert len(ok) == 1
    np.testing.assert_array_equal(ok[0]["payload"][:200], payload)


@pytest.mark.parametrize("Mx,cpx", [(64, 8), (24, 4), (128, 16)])
def test_alternate_dimensions(Mx, cpx):
    """Other OFDM geometries (the fullduplex M=64/cp=8 usage point and
    extremes) assemble and decode."""
    params = ofdm.make_ofdm_params(M=Mx, cp_len=cpx, taper_len=min(4, cpx))
    sync = ofdm_sync.make_sync(params, block_size=8192, max_payload=128,
                               max_frames=4)
    step = ofdm_sync.make_sync_step(sync)
    props = ofdm.default_props()
    rng = np.random.default_rng(Mx)
    header = rng.integers(0, 256, 8, dtype=np.uint8)
    payload = rng.integers(0, 256, 96, dtype=np.uint8)
    samples = np.asarray(ofdm.assemble_frame(
        params, props, jnp.asarray(header), jnp.asarray(payload)))
    stream = np.zeros(2500 + len(samples), np.complex64)
    stream[800:800 + len(samples)] = samples
    ch = chan.Channel(snr_db=25.0, cfo=0.002)
    stream = np.asarray(chan.channel_apply(
        ch, jax.random.PRNGKey(Mx), jnp.asarray(stream), signal_power=0.8))
    frames = _run_stream(sync, step, stream)
    ok = [f for f in frames if f["payload_valid"]]
    assert len(ok) == 1, (Mx, frames)
    np.testing.assert_array_equal(ok[0]["payload"][:96], payload)


@pytest.mark.slow
def test_stress_mixed_props_stream(setup):
    """Integration stress: many frames with randomized props/lengths in one
    noisy stream — every one must decode exactly."""
    params, sync, step = setup
    rng = np.random.default_rng(123)
    mods = [modem.MOD_BPSK, modem.MOD_QPSK, modem.MOD_PSK8, modem.MOD_QAM16,
            modem.MOD_QAM64]
    fecs = [fec.FEC_NONE, fec.FEC_HAMMING74, fec.FEC_HAMMING128,
            fec.FEC_GOLAY2412, fec.FEC_SECDED2216]
    sent = []
    pos = 800
    stream = np.zeros(120000, np.complex64)
    while True:
        props = ofdm.FrameProps(
            check=int(rng.choice([crc.CRC_16, crc.CRC_32])),
            fec0=int(rng.choice(fecs)), fec1=int(rng.choice(fecs)),
            mod=int(rng.choice(mods)))
        plen = int(rng.integers(8, 400))
        header = rng.integers(0, 256, 8, dtype=np.uint8)
        payload = rng.integers(0, 256, plen, dtype=np.uint8)
        # rx_max_payload: the paired sync's budget — random heavy pairs
        # (e.g. g2412+h128 = 3.01x) fit because plen < max_payload
        frame = np.asarray(ofdm.assemble_frame(
            params, props, jnp.asarray(header), jnp.asarray(payload),
            rx_max_payload=sync.max_payload))
        if pos + len(frame) + sync.overlap >= len(stream):
            break
        stream[pos:pos + len(frame)] = frame
        sent.append((pos, payload))
        pos += len(frame) + int(rng.integers(400, 1200))
    assert len(sent) >= 8
    ch = chan.Channel(snr_db=28.0, cfo=0.001)
    stream = np.asarray(chan.channel_apply(
        ch, jax.random.PRNGKey(99), jnp.asarray(stream), signal_power=0.5))
    frames = _run_stream(sync, step, stream)
    ok = {f["t"]: f for f in frames if f["payload_valid"]}
    assert len(ok) == len(sent), (len(ok), len(sent))
    for pos, payload in sent:
        match = [f for t, f in ok.items() if abs(t - pos) <= 2]
        assert len(match) == 1, pos
        np.testing.assert_array_equal(
            match[0]["payload"][: len(payload)], payload)


@pytest.mark.slow
def test_batched_blocks_equal_sequential(setup):
    """sync_blocks_batched == scan of sync_block: same detections, same
    payloads, same stats, on a loaded multi-frame stream (multi-block
    batched dispatch)."""
    params, sync, step = setup
    props = ofdm.FrameProps()
    rng = np.random.default_rng(17)
    pieces = []
    truth = []
    for i in range(5):
        h, p, s = _make_frame(params, props, 100 + i, 128 + 32 * i)
        pieces.append(np.zeros(int(rng.integers(300, 1200)), np.complex64))
        pieces.append(s)
        truth.append((h, p))
    stream = np.concatenate(pieces)
    n_blocks = -(-len(stream) // sync.block_size) + \
        int(np.ceil(sync.overlap / sync.block_size)) + 1
    stream = np.concatenate(
        [stream, np.zeros(n_blocks * sync.block_size - len(stream),
                          np.complex64)])
    noise = (0.01 * (rng.normal(size=stream.shape) +
                     1j * rng.normal(size=stream.shape))).astype(np.complex64)
    stream = stream + noise

    seq = _run_stream(sync, step, stream[: n_blocks * sync.block_size])

    import jax
    state = ofdm_sync.sync_init(sync)
    blocks = jnp.asarray(stream.reshape(n_blocks, sync.block_size))
    state2, res = ofdm_sync.sync_blocks_batched(sync, state, blocks)
    res = jax.tree.map(np.asarray, res)
    bat = []
    for b, k in zip(*np.nonzero(res.detected)):
        bat.append({
            "t": int(res.t_start[b, k]),
            "header_valid": bool(res.header_valid[b, k]),
            "payload_valid": bool(res.payload_valid[b, k]),
            "payload": np.asarray(res.payload[b, k]),
            "payload_len": int(res.payload_len[b, k]),
        })
    bat = sorted(bat, key=lambda f: f["t"])
    assert len(bat) == len(seq) == 5
    for fb, fs in zip(bat, seq):
        assert fb["t"] == fs["t"]
        assert fb["header_valid"] == fs["header_valid"] is True
        assert fb["payload_valid"] == fs["payload_valid"] is True
        assert fb["payload_len"] == fs["payload_len"]
        assert np.array_equal(fb["payload"], fs["payload"])
    # carried state identical to the sequential run's final state
    st_seq = ofdm_sync.sync_init(sync)
    for b in range(n_blocks):
        st_seq, _ = step(st_seq, blocks[b])
    np.testing.assert_array_equal(np.asarray(state2.tail),
                                  np.asarray(st_seq.tail))
    assert int(state2.base) == int(st_seq.base)


def test_back_to_back_frames(setup):
    """Frames with (near) zero inter-frame gap: the static decode window
    extends into the next burst, whose pilots must not corrupt this
    frame's phase-trend fit (round-2 boundary-gate regression)."""
    params, sync, step = setup
    props = ofdm.FrameProps()
    rng = np.random.default_rng(23)
    pieces, truth = [], []
    pieces.append(np.zeros(800, np.complex64))
    for i in range(4):
        h, p, s = _make_frame(params, props, 300 + i, 192)
        pieces.append(s)
        pieces.append(np.zeros(8, np.complex64))   # nearly contiguous
        truth.append(p)
    stream = np.concatenate(pieces)
    stream = stream + (0.03 * (rng.normal(size=stream.shape) +
                               1j * rng.normal(size=stream.shape))
                       ).astype(np.complex64)
    frames = _run_stream(sync, step, stream)
    ok = [f for f in frames if f["payload_valid"]]
    assert len(ok) == 4
    for f, want in zip(sorted(ok, key=lambda x: x["t"]), truth):
        assert np.array_equal(f["payload"][:192], want)


@pytest.mark.slow
def test_block_size_invariance_multiframe_stress(setup):
    """Randomized multi-frame stream chopped at four block sizes (incl. a
    non-power-of-two) yields frame-for-frame identical results — frames
    deliberately straddle every chopping's block boundaries."""
    params, _, _ = setup
    rng = np.random.default_rng(42)
    total = 60000
    base = np.zeros(total, np.complex64)
    sent = []
    pos = 700
    while True:
        props = ofdm.FrameProps()
        _, payload, samples = _make_frame(
            params, props, int(rng.integers(0, 1 << 16)),
            int(rng.integers(40, 200)))
        if pos + len(samples) > total - 14000:
            break
        base[pos:pos + len(samples)] = samples
        sent.append((pos, payload))
        pos += len(samples) + int(rng.integers(900, 2600))
    assert len(sent) >= 3
    ch = chan.Channel(snr_db=26.0, cfo=0.002)
    stream = np.asarray(chan.channel_apply(
        ch, jax.random.PRNGKey(3), jnp.asarray(base), signal_power=0.8))

    all_results = []
    for bs in (12288, 8192, 4096, 2048):
        s = ofdm_sync.make_sync(params, block_size=bs, max_payload=512,
                                max_frames=4)
        st = ofdm_sync.make_sync_step(s)
        frames = sorted(_run_stream(s, st, stream), key=lambda f: f["t"])
        all_results.append((bs, frames))

    bs0, ref = all_results[0]
    assert len(ref) == len(sent)
    for (pos, payload), f in zip(sent, ref):
        assert f["payload_valid"], f
        np.testing.assert_array_equal(
            f["payload"][: len(payload)], payload)
    for bs, frames in all_results[1:]:
        assert len(frames) == len(ref), (bs, len(frames), len(ref))
        for a, b in zip(ref, frames):
            assert a["t"] == b["t"], bs
            assert a["payload_len"] == b["payload_len"], bs
            np.testing.assert_array_equal(a["payload"], b["payload"])


def test_custom_subcarrier_allocation_loopback():
    """The ofdmflexframegen_create ``p`` surface: a hand-built allocation
    (wider guards, denser pilots than the default) must round-trip
    payload-exact through the standard synchronizer."""
    M_ = 64
    alloc = np.full(M_, ofdm.SCTYPE_DATA, np.int32)
    alloc[0] = ofdm.SCTYPE_NULL                      # DC
    for g in range(-6, 7):                           # wide guard band
        alloc[(M_ // 2 + g) % M_] = ofdm.SCTYPE_NULL
    for k in (4, 12, 20, 28, 36, 44, 52, 60):        # dense pilots
        if alloc[k] == ofdm.SCTYPE_DATA:
            alloc[k] = ofdm.SCTYPE_PILOT
    params = ofdm.make_ofdm_params(M=M_, cp_len=8, taper_len=4,
                                   alloc=alloc)
    assert len(params.pilot_idx) >= 2
    np.testing.assert_array_equal(
        np.sort(np.concatenate([params.data_idx, params.pilot_idx,
                                params.null_idx])), np.arange(M_))
    sync = ofdm_sync.make_sync(params, block_size=8192, max_payload=128,
                               max_frames=2)
    step = ofdm_sync.make_sync_step(sync)
    props = ofdm.default_props()
    rng = np.random.default_rng(21)
    header = rng.integers(0, 256, 8, dtype=np.uint8)
    payload = rng.integers(0, 256, 100, dtype=np.uint8)
    samples = np.asarray(ofdm.assemble_frame(
        params, props, jnp.asarray(header), jnp.asarray(payload)))
    stream = np.zeros(3000 + len(samples), np.complex64)
    stream[900:900 + len(samples)] = samples
    ch = chan.Channel(snr_db=20.0, cfo=0.0015)
    stream = np.asarray(chan.channel_apply(
        ch, jax.random.PRNGKey(5), jnp.asarray(stream), signal_power=0.8))
    frames = _run_stream(sync, step, stream)
    ok = [f for f in frames if f["payload_valid"]]
    assert len(ok) == 1, frames
    np.testing.assert_array_equal(ok[0]["payload"][:100], payload)
    np.testing.assert_array_equal(ok[0]["header"], header)


def test_custom_allocation_validation():
    M_ = 48
    with pytest.raises(ValueError, match="M=48 entries"):
        ofdm.make_ofdm_params(M=M_, alloc=np.zeros(32, np.int32))
    bad = np.full(M_, 7, np.int32)
    with pytest.raises(ValueError, match="SCTYPE"):
        ofdm.make_ofdm_params(M=M_, alloc=bad)
    no_pilots = np.full(M_, ofdm.SCTYPE_DATA, np.int32)
    with pytest.raises(ValueError, match="pilot"):
        ofdm.make_ofdm_params(M=M_, alloc=no_pilots)
    # nulling every 4th subcarrier starves the S0 detector
    starved = np.full(M_, ofdm.SCTYPE_DATA, np.int32)
    starved[::4] = ofdm.SCTYPE_NULL
    starved[1] = ofdm.SCTYPE_PILOT
    starved[2] = ofdm.SCTYPE_PILOT
    with pytest.raises(ValueError, match="S0"):
        ofdm.make_ofdm_params(M=M_, alloc=starved)


def test_over_budget_props_raise_at_assemble():
    """v27 inner + default h128 outer expands 3.01x > the default
    expansion=3 receive budget; silently truncating the encoded tail used
    to corrupt the trailing CRC (payload bytes perfect, payload_valid
    False at any SNR).  assemble must fail loudly instead."""
    params = ofdm.make_ofdm_params(M=M, cp_len=CP, taper_len=TAPER)
    props = ofdm.FrameProps(check=crc.CRC_32, fec0=fec.FEC_CONV_V27,
                            fec1=fec.FEC_HAMMING128, mod=modem.MOD_QPSK)
    payload = np.arange(200, dtype=np.uint8)
    with pytest.raises(ValueError, match="expansion"):
        ofdm.assemble_frame(params, props, jnp.zeros(8, jnp.uint8),
                            jnp.asarray(payload))


@pytest.mark.slow
def test_conv_plus_outer_fec_with_raised_expansion():
    """The regression case behind check_budget: fec0=v27 + fec1=h128 at
    200 bytes round-trips payload-exact when BOTH ends are built for
    expansion=4."""
    params = ofdm.make_ofdm_params(M=M, cp_len=CP, taper_len=TAPER)
    sync = ofdm_sync.make_sync(params, block_size=8192, max_payload=200,
                               max_frames=2, enable_conv=True, expansion=4)
    step = ofdm_sync.make_sync_step(sync)
    props = ofdm.FrameProps(check=crc.CRC_32, fec0=fec.FEC_CONV_V27,
                            fec1=fec.FEC_HAMMING128, mod=modem.MOD_QPSK)
    rng = np.random.default_rng(0)
    header = rng.integers(0, 256, 8, dtype=np.uint8)
    payload = rng.integers(0, 256, 200, dtype=np.uint8)
    samples = np.asarray(ofdm.assemble_frame(
        params, props, jnp.asarray(header), jnp.asarray(payload),
        expansion=4))
    stream = np.zeros(2000 + len(samples), np.complex64)
    stream[700:700 + len(samples)] = samples
    ch = chan.Channel(snr_db=20.0)
    stream = np.asarray(chan.channel_apply(
        ch, jax.random.PRNGKey(8), jnp.asarray(stream), signal_power=0.8))
    frames = _run_stream(sync, step, stream)
    ok = [f for f in frames if f["payload_valid"]]
    assert len(ok) == 1, frames
    np.testing.assert_array_equal(ok[0]["payload"][:200], payload)


def test_debug_capture_internals():
    """debug_capture returns the synchronizer internals the reference's
    debug dump records (lib/ofdmtxrx.cc:518-525): channel estimate and
    equalized constellation points that cluster on the TX scheme."""
    params = ofdm.make_ofdm_params(M=48, cp_len=6, taper_len=4)
    sync = ofdm_sync.make_sync(params, block_size=8192, max_payload=256,
                               max_frames=4)
    rng = np.random.default_rng(3)
    header = rng.integers(0, 256, 8, dtype=np.uint8)
    payload = rng.integers(0, 256, 100, dtype=np.uint8)
    w = np.asarray(ofdm.assemble_frame(
        params, ofdm.default_props(), jnp.asarray(header),
        jnp.asarray(payload)))
    stream = np.zeros(8192, np.complex64)
    stream[500:500 + len(w)] = w
    stream += 0.01 * (rng.normal(size=8192) +
                      1j * rng.normal(size=8192)).astype(np.complex64)
    cap = ofdm_sync.debug_capture(sync, stream)
    assert cap["detected"] and cap["header_valid"]
    assert abs(cap["n0"] - 500) <= 2    # offset within the capture
    assert cap["H"].shape == (48,)
    active = np.abs(cap["H"]) > 1e-6
    np.testing.assert_allclose(np.abs(cap["H"][active]).mean(), 1.0,
                               atol=0.05)
    pts = cap["psyms_eq"]          # QPSK: clusters at (+-1 +- 1j)/sqrt(2)
    err = (np.abs(np.abs(pts.real) - 2 ** -0.5).mean()
           + np.abs(np.abs(pts.imag) - 2 ** -0.5).mean())
    assert err < 0.05, err
    assert cap["hsyms_eq"].shape[0] > 0
    assert cap["metric"].max() > sync.threshold
