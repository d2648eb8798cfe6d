"""Multichannel OFDM transceivers over a polyphase channelizer.

Capability parity with the reference's three classes:

* ``multichanneltx`` (/root/reference/lib/multichanneltx.cc): N independent
  ofdmflexframegens feed bins 0..N-1 of a 2N-channel polyphase synthesizer
  (ctor 41-100: Kaiser m=13 As=60; NCO spectrum centering offset
  -0.5*(N-1)/N*pi at 94-96); ``GenerateSamples`` emits 2N samples per
  channel-sample (192-227); ``UpdateData``/``IsChannelReadyForData``
  (152-189) schedule per-channel packets, idle channels emit zeros (239).
* ``multichannelrx`` (/root/reference/lib/multichannelrx.cc): NCO mix-down,
  2N-channel analyzer (m=7), one ofdmflexframesync per channel (45-104,
  155-195).  The reference runs the per-channel syncs serially with a
  ``TODO: make this multi-threaded`` (184); here they are **vmapped** over
  the channel axis — the on-chip form of channel parallelism (SURVEY.md
  §2.2), and the axis `shard_map`s across devices in the parallel layer.
* ``multichanneltxrx`` (/root/reference/lib/multichanneltxrx.cc): the
  composition with TX/RX workers and channel-availability polling
  (217-299); the worker threads become block-wise pure steps.

Block-step shape: the reference's per-sample NCO + every-2N-samples
channelizer firing (lib/multichannelrx.cc:155-182) becomes one fused jitted
step over a whole IQ block: ``mix -> [T/2N, 2N] analyze -> vmapped N-channel
sync``.
"""
from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..framing import ofdm, ofdm_sync
from ..framing import payload as payload_codec
from ..ops import iqfmt
from ..ops import nco as nco_mod
from ..ops import pfb as pfb_mod

__all__ = ["MultichannelTx", "MultichannelRx", "MultichannelTxRx",
           "McrxState", "make_mcrx_step", "make_mcrx_batched_step",
           "MctxState", "make_mctx_step"]


def _center_offset(num_channels: int) -> float:
    """Spectrum-centering NCO frequency (rad/sample), matching the
    reference's design point (lib/multichanneltx.cc:94-96)."""
    return -0.5 * (num_channels - 1) / num_channels * np.pi


# ---------------------------------------------------------------------------
# TX
# ---------------------------------------------------------------------------

class MultichannelTx:
    """N-channel OFDM downlink synthesizer (host scheduling + jitted DSP)."""

    def __init__(self, num_channels: int, M: int = 48, cp_len: int = 6,
                 taper_len: int = 4,
                 expansion: int = payload_codec.EXPANSION):
        self.num_channels = num_channels
        self.params = ofdm.make_ofdm_params(M, cp_len, taper_len)
        self.expansion = int(expansion)
        self.props = [ofdm.default_props() for _ in range(num_channels)]
        self.chz = pfb_mod.pfbch_create(2 * num_channels, m=13, As=60.0)
        self._mctx_init, self._mctx_step = make_mctx_step(num_channels)
        self._mctx_state = self._mctx_init()
        # per-channel pending baseband samples (time-domain frame streams)
        self._queues: list[np.ndarray] = [
            np.zeros(0, np.complex64) for _ in range(num_channels)]
        # async TX worker (the reference's tx_worker thread that keeps the
        # radio fed ahead of the consumption cursor,
        # lib/multichanneltxrx.cc:430-500); idle until start_worker()
        self._cv = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._running = False
        self._ahead: list[np.ndarray] = []   # produced, unconsumed samples
        self._ahead_len = 0
        self._max_ahead = 0

    def GetNumChannels(self) -> int:
        """Reference-casing accessor (include/multichanneltx.h:50)."""
        return self.num_channels

    def Reset(self):
        """Drop queued packets + carried synthesis state
        (multichanneltx::Reset, lib/multichanneltx.cc:104-126)."""
        with self._cv:
            self._queues = [np.zeros(0, np.complex64)
                            for _ in range(self.num_channels)]
            self._mctx_state = self._mctx_init()
            self._ahead = []
            self._ahead_len = 0

    def is_channel_ready(self, ch: int) -> bool:
        """True when channel ``ch`` has drained its queued frame
        (= !ofdmflexframegen_is_assembled, lib/multichanneltx.cc:152-162)."""
        with self._cv:
            return len(self._queues[ch]) == 0

    def update_data(self, ch: int, header, payload, mod=None, fec0=None,
                    fec1=None):
        """Queue one packet on channel ``ch`` (UpdateData, :165-189)."""
        if not self.is_channel_ready(ch):
            raise RuntimeError(f"channel {ch} not ready for data")
        p = self.props[ch]
        if mod is not None or fec0 is not None or fec1 is not None:
            p = ofdm.FrameProps(
                check=p.check,
                fec0=p.fec0 if fec0 is None else fec0,
                fec1=p.fec1 if fec1 is None else fec1,
                mod=p.mod if mod is None else mod)
            self.props[ch] = p
        samples = np.asarray(ofdm.assemble_frame(
            self.params, p,
            jnp.asarray(np.asarray(header, dtype=np.uint8)),
            jnp.asarray(np.asarray(payload, dtype=np.uint8)),
            expansion=self.expansion))
        with self._cv:
            # re-check under the lock: the early fail-fast check above
            # raced any concurrent producer (check-then-act), and a
            # silent overwrite would drop their packet
            if len(self._queues[ch]):
                raise RuntimeError(f"channel {ch} not ready for data")
            self._queues[ch] = samples
            self._cv.notify_all()

    def generate_samples(self, n_channel_samples: int) -> np.ndarray:
        """Produce ``2N * n_channel_samples`` output samples.

        Each channel contributes ``n_channel_samples`` baseband samples from
        its queue (zeros when idle, :239); one fused synthesize + mix.
        With the async worker running, use :meth:`read_samples` instead —
        the worker owns the generation cursor.
        """
        with self._cv:
            return self._generate(n_channel_samples)

    def _generate(self, n_channel_samples: int) -> np.ndarray:
        """Core generation; caller holds ``self._cv``."""
        N = self.num_channels
        Y = np.zeros((n_channel_samples, 2 * N), dtype=np.complex64)
        for ch in range(N):
            q = self._queues[ch]
            take = min(len(q), n_channel_samples)
            if take:
                Y[:take, ch] = q[:take]
                self._queues[ch] = q[take:]
        self._mctx_state, y = self._mctx_step(self._mctx_state,
                                              jnp.asarray(Y))
        return np.asarray(y)

    # -- async TX worker ----------------------------------------------------
    # The reference streams TX from a dedicated worker thread that keeps
    # the radio fed ahead of the consumption cursor while the main thread
    # queues packets (tx_worker, lib/multichanneltxrx.cc:430-500).  Here the
    # worker pre-generates into a bounded ahead-buffer; the consumer's
    # read_samples() blocks on the producer, and the producer blocks when
    # max_ahead samples are already buffered (bounded memory).

    def start_worker(self, chunk: int = 256, max_ahead: int = 65536):
        """Start ahead-of-cursor production (``chunk`` channel-samples per
        step, at most ``max_ahead`` output samples buffered)."""
        with self._cv:
            if self._running:
                return
            self._running = True
            self._max_ahead = int(max_ahead)
        self._worker = threading.Thread(
            target=self._produce_loop, args=(int(chunk),), daemon=True)
        self._worker.start()

    def _produce_loop(self, chunk: int):
        try:
            while True:
                with self._cv:
                    while (self._running
                           and self._ahead_len >= self._max_ahead):
                        self._cv.wait(0.1)
                    if not self._running:
                        return
                    y = self._generate(chunk)
                    self._ahead.append(y)
                    self._ahead_len += len(y)
                    self._cv.notify_all()
        finally:
            # a generation failure must not strand consumers in their
            # wait loops: clear the running flag and wake everyone (the
            # exception itself surfaces via threading.excepthook)
            with self._cv:
                self._running = False
                self._cv.notify_all()

    @property
    def samples_ahead(self) -> int:
        """Output samples produced ahead of the consumption cursor."""
        with self._cv:
            return self._ahead_len

    def read_samples(self, n: int) -> np.ndarray:
        """Consume ``n`` output samples from the ahead-buffer (blocking
        while the worker produces; tops up synchronously when the worker
        is stopped OR when ``n`` exceeds ``max_ahead`` — the producer
        parks at the bound, so waiting past it would never progress)."""
        with self._cv:
            while (self._running and self._ahead_len < n
                   and self._ahead_len < self._max_ahead):
                self._cv.wait(0.1)
            if self._ahead_len < n:
                # worker stopped or demand exceeds the ahead bound:
                # drain deterministically (generation serialized by _cv)
                miss = n - self._ahead_len
                per_step = 2 * self.num_channels
                y = self._generate(-(-miss // per_step))
                self._ahead.append(y)
                self._ahead_len += len(y)
            # consume chunk-by-chunk from the front: O(n) copied per
            # call, not O(buffered) (the ahead buffer can be large)
            out, taken = [], 0
            while taken < n:
                head = self._ahead[0]
                take = min(len(head), n - taken)
                out.append(head[:take])
                if take == len(head):
                    self._ahead.pop(0)
                else:
                    self._ahead[0] = head[take:]
                taken += take
            self._ahead_len -= n
            self._cv.notify_all()
            return (out[0] if len(out) == 1
                    else np.concatenate(out) if out
                    else np.zeros(0, np.complex64))

    def stop_worker(self):
        """Stop the producer; buffered samples remain readable."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join()
            self._worker = None


class MctxState(NamedTuple):
    nco: nco_mod.NcoState
    chz: pfb_mod.PfbchState


def make_mctx_step(num_channels: int):
    """Build ``(init_state, step)`` for the fused synthesis side.

    ``step(state, Y[B, 2N]) -> (state', y[2N*B])``: per-channel baseband
    frames (channels in bins 0..N-1, rest zero) -> synthesized + centered
    mixture.  One jitted graph per block — the device-side counterpart of
    the host-scheduling :class:`MultichannelTx`.
    """
    N = num_channels
    chz = pfb_mod.pfbch_create(2 * N, m=13, As=60.0)

    @jax.jit                      # compiled init (see make_mcrx_step)
    def init_state() -> MctxState:
        return MctxState(nco=nco_mod.nco_init(_center_offset(N)),
                         chz=pfb_mod.pfbch_state(chz))

    @jax.jit
    def step(state: MctxState, Y: jnp.ndarray):
        chz_state, y = pfb_mod.pfb_synthesize_block(chz, state.chz, Y)
        nco_state, y = nco_mod.nco_mix_block(state.nco, y, up=True)
        return MctxState(nco=nco_state, chz=chz_state), y

    return init_state, step


# ---------------------------------------------------------------------------
# RX — pure step (vmapped channel syncs) + host wrapper
# ---------------------------------------------------------------------------

class McrxState(NamedTuple):
    nco: nco_mod.NcoState
    chz: pfb_mod.PfbchState
    syncs: ofdm_sync.OfdmSyncState      # stacked leading axis [N]


def make_mcrx_step(num_channels: int, sync: ofdm_sync.OfdmSync):
    """Build ``(init_state, step)`` for the fused multichannel RX.

    ``step(state, x[2N*B]) -> (state', FrameResults[N, max_frames])`` where
    ``B = sync.block_size`` channel-samples per channel per step.
    """
    N = num_channels
    chz = pfb_mod.pfbch_create(2 * N, m=7, As=60.0)

    @jax.jit                      # one compiled fill for the whole state
    def init_state() -> McrxState:
        one = ofdm_sync.sync_init(sync)
        stacked = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (N,) + x.shape), one)
        return McrxState(
            nco=nco_mod.nco_init(-_center_offset(N)),
            chz=pfb_mod.pfbch_state(chz),
            syncs=stacked)

    @jax.jit
    def step(state: McrxState, x: jnp.ndarray):
        # x: complex64 [2N*B] or reduced-precision IQ planes [2, 2N*B]
        nco_state, y = nco_mod.nco_mix_block(state.nco,
                                             iqfmt.iq_from_any(x), up=True)
        chz_state, X = pfb_mod.pfb_analyze_block(chz, state.chz, y)
        chans = X[:, :N].T                      # [N, B] per-channel streams
        # all channels' candidates decode in one flat batch behind one
        # global gate — vmap(sync_block) turned each channel's lax.cond
        # into an always-run select (see ofdm_sync.sync_channels_batched)
        sync_states, results = ofdm_sync.sync_channels_batched(
            sync, state.syncs, chans[:, None, :])
        results = jax.tree.map(lambda v: v[:, 0], results)  # drop block axis
        return McrxState(nco=nco_state, chz=chz_state,
                         syncs=sync_states), results

    return init_state, step


def make_mcrx_batched_step(num_channels: int,
                           sync: ofdm_sync.OfdmSync, n_blocks: int):
    """Multi-block batched multichannel RX step (one dispatch, no scan).

    ``step(state, x[2N * block_size * n_blocks]) -> (state',
    FrameResults[N, n_blocks, max_frames])``: the whole chunk is mixed and
    channelized in one pass, then each channel runs the vmapped multi-block
    synchronizer (:func:`ofdm_sync.sync_blocks_batched`) — the detect
    front-end parallelizes over blocks AND channels, and all candidates
    decode in one flat batch.  This amortizes the per-block fixed cost that
    dominates small-block throughput.
    """
    N = num_channels
    chz = pfb_mod.pfbch_create(2 * N, m=7, As=60.0)
    bs = sync.block_size

    @jax.jit                      # one compiled fill for the whole state
    def init_state() -> McrxState:
        one = ofdm_sync.sync_init(sync)
        stacked = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (N,) + x.shape), one)
        return McrxState(
            nco=nco_mod.nco_init(-_center_offset(N)),
            chz=pfb_mod.pfbch_state(chz),
            syncs=stacked)

    @jax.jit
    def step(state: McrxState, x: jnp.ndarray):
        # x: complex64 [2N*bs*n_blocks] or IQ planes [2, 2N*bs*n_blocks]
        nco_state, y = nco_mod.nco_mix_block(state.nco,
                                             iqfmt.iq_from_any(x), up=True)
        chz_state, X = pfb_mod.pfb_analyze_block(chz, state.chz, y)
        chans = X[:, :N].T                      # [N, bs*n_blocks]
        sync_states, results = ofdm_sync.sync_channels_batched(
            sync, state.syncs, chans.reshape(N, n_blocks, bs))
        return McrxState(nco=nco_state, chz=chz_state,
                         syncs=sync_states), results

    return init_state, step


class MultichannelRx:
    """N-channel uplink analyzer with vmapped per-channel frame sync."""

    def __init__(self, num_channels: int, M: int = 48, cp_len: int = 6,
                 taper_len: int = 4, callback=None, block_size: int = 4096,
                 max_payload: int = 1024, enable_conv: bool = False,
                 soft: bool = False,
                 expansion: int = payload_codec.EXPANSION):
        self.num_channels = num_channels
        self.params = ofdm.make_ofdm_params(M, cp_len, taper_len)
        self.sync = ofdm_sync.make_sync(
            self.params, block_size=block_size, max_payload=max_payload,
            enable_conv=enable_conv, soft=soft, expansion=expansion)
        self.callback = callback
        init, self._step = make_mcrx_step(num_channels, self.sync)
        self._init = init
        self._state = init()
        self._pending = np.zeros(0, np.complex64)

    def GetNumChannels(self) -> int:
        """Reference-casing accessor (include/multichannelrx.h:54)."""
        return self.num_channels

    def Reset(self):
        """Drop carried analyzer + per-channel sync state
        (multichannelrx::Reset, lib/multichannelrx.cc:108-131)."""
        self._state = self._init()
        self._pending = np.zeros(0, np.complex64)

    @property
    def granularity(self) -> int:
        return 2 * self.num_channels * self.sync.block_size

    def execute(self, samples: np.ndarray) -> list[dict]:
        """Feed mixture samples; returns decoded frames across channels.

        (The block replacement for per-sample Execute,
        lib/multichannelrx.cc:155-182.)
        """
        buf = np.concatenate([self._pending, np.asarray(samples)])
        g = self.granularity
        frames = []
        while len(buf) >= g:
            chunk, buf = buf[:g], buf[g:]
            self._state, res = self._step(
                self._state, jnp.asarray(chunk, jnp.complex64))
            det = np.asarray(res.detected)
            for ch, i in zip(*np.nonzero(det)):
                row = {
                    "channel": int(ch),
                    "t": int(res.t_start[ch, i]),
                    "header": np.asarray(res.header[ch, i]),
                    "header_valid": bool(res.header_valid[ch, i]),
                    "payload": np.asarray(res.payload[ch, i])[
                        : int(res.payload_len[ch, i])],
                    "payload_valid": bool(res.payload_valid[ch, i]),
                    "payload_len": int(res.payload_len[ch, i]),
                    "stats": {"rssi": float(res.rssi[ch, i]),
                              "evm": float(res.evm[ch, i]),
                              "cfo": float(res.cfo[ch, i])},
                }
                frames.append(row)
                if self.callback is not None:
                    self.callback(**row)
        # copy: a view would pin the whole concatenated input buffer
        # until the next call
        self._pending = buf.copy()
        return frames

    def flush(self) -> list[dict]:
        pad = self.granularity * (
            1 + (2 * self.num_channels * self.sync.overlap)
            // self.granularity + 1)
        return self.execute(np.zeros(pad, np.complex64))

    def channelize(self, samples: np.ndarray) -> np.ndarray:
        """Offline/debug helper: mixture -> per-channel baseband streams
        ``[N, len // 2N]`` through the same NCO + PFB front-end, from a
        FRESH state (the streaming state is untouched).  Feeds the
        per-channel framesync debug dumps — the reference hardwires
        per-channel debug capture into its RX
        (/root/reference/lib/multichannelrx.cc:83-85,118-122)."""
        N = self.num_channels
        g = 2 * N
        x = np.asarray(samples, np.complex64)
        x = x[: (len(x) // g) * g]
        chz = pfb_mod.pfbch_create(g, m=7, As=60.0)
        _, y = nco_mod.nco_mix_block(
            nco_mod.nco_init(-_center_offset(N)),
            jnp.asarray(x), up=True)
        _, X = pfb_mod.pfb_analyze_block(chz, pfb_mod.pfbch_state(chz), y)
        return np.asarray(X[:, :N].T)


# ---------------------------------------------------------------------------
# full duplex composition
# ---------------------------------------------------------------------------

class MultichannelTxRx:
    """TX + RX composition (the multichanneltxrx surface: non-blocking
    transmit_packet + channel availability polling,
    /root/reference/lib/multichanneltxrx.cc:217-299)."""

    def __init__(self, num_channels: int, M: int = 48, cp_len: int = 6,
                 taper_len: int = 4, callback=None, **rx_kwargs):
        from .ofdmtxrx import RadioConfig
        self.tx = MultichannelTx(
            num_channels, M, cp_len, taper_len,
            expansion=rx_kwargs.get("expansion", payload_codec.EXPANSION))
        self.rx = MultichannelRx(num_channels, M, cp_len, taper_len,
                                 callback=callback, **rx_kwargs)
        self.num_channels = num_channels
        self.radio = RadioConfig()
        self._rx_running = False

    # -- radio parameter surface (multichanneltxrx.h:67-112) ---------------
    def set_tx_freq(self, f: float):
        self.radio.tx_freq = f

    def set_tx_rate(self, r: float):
        self.radio.tx_rate = r

    def set_tx_gain_soft(self, g_db: float):
        self.radio.tx_gain_soft = g_db

    def set_tx_gain_uhd(self, g_db: float):
        self.radio.tx_gain_uhd = g_db

    def set_tx_antenna(self, name: str):
        self.radio.tx_antenna = name

    def set_rx_freq(self, f: float):
        self.radio.rx_freq = f

    def set_rx_rate(self, r: float):
        self.radio.rx_rate = r

    def set_rx_gain_uhd(self, g_db: float):
        self.radio.rx_gain_uhd = g_db

    def set_rx_antenna(self, name: str):
        self.radio.rx_antenna = name

    def reset_tx(self):
        self.tx.Reset()

    def reset_rx(self):
        self.rx.Reset()

    def start_rx(self):
        self._rx_running = True

    def stop_rx(self):
        self._rx_running = False

    def run_rx(self, samples) -> list:
        """Feed mixture samples while RX is started (the rx_worker gate,
        lib/multichanneltxrx.cc:508-554)."""
        if not self._rx_running:
            return []
        return self.rx.execute(samples)

    def transmit_packet(self, ch: int, header, payload, mod=None,
                        fec0=None, fec1=None) -> bool:
        if not self.tx.is_channel_ready(ch):
            return False
        self.tx.update_data(ch, header, payload, mod, fec0, fec1)
        return True

    def is_channel_available(self, ch: int) -> bool:
        return self.tx.is_channel_ready(ch)

    def get_available_channel(self) -> Optional[int]:
        for ch in range(self.num_channels):
            if self.tx.is_channel_ready(ch):
                return ch
        return None

    def wait_for_channel(self, ch: int) -> np.ndarray:
        """Drain samples until channel ``ch`` is ready for data.

        The reference blocks in a usleep-poll loop while its TX worker
        drains (lib/multichanneltxrx.cc:270-281).  With the async worker
        running this consumes from its ahead-buffer (the worker owns the
        generation cursor); otherwise draining *is* the sample
        generation.  Either way the drained air is returned to the
        caller (empty when the channel was already free).
        """
        out = []
        was_waiting = not self.tx.is_channel_ready(ch)
        while not self.tx.is_channel_ready(ch):
            # read_samples drains any worker ahead-buffer FIRST and only
            # then generates — correct whether the worker is running,
            # stopped-with-buffered-samples, or was never started
            out.append(self.tx.read_samples(512))
        if was_waiting:
            # the frame tail synthesized past the queue-empty edge may
            # still be buffered — include it, so the returned air
            # carries the whole packet
            out.append(self.tx.read_samples(self.tx.samples_ahead))
        return (np.concatenate(out) if out
                else np.zeros(0, np.complex64))

    def wait_for_tx_to_complete(self) -> np.ndarray:
        """Drain all queued frames to samples (the worker-thread drain,
        lib/multichanneltxrx.cc:478-494)."""
        out = []
        while not all(self.tx.is_channel_ready(c)
                      for c in range(self.num_channels)):
            out.append(self.tx.read_samples(512))
        # drain whatever is still buffered (the synthesized frame tail
        # when a worker ran) plus the channelizer-memory flush margin
        flush = 2 * self.tx.chz.P
        out.append(self.tx.read_samples(
            self.tx.samples_ahead + 2 * self.num_channels * flush))
        return (np.concatenate(out) if out
                else np.zeros(0, np.complex64))

    # async-TX composition (start_tx/stop_tx, lib/multichanneltxrx.cc:
    # 302-346): production runs ahead of the consumer on a worker thread
    def start_tx(self, chunk: int = 256, max_ahead: int = 65536):
        self.tx.start_worker(chunk=chunk, max_ahead=max_ahead)

    def stop_tx(self):
        self.tx.stop_worker()

    def read_tx_samples(self, n: int) -> np.ndarray:
        return self.tx.read_samples(n)
