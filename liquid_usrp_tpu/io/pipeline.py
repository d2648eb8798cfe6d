"""Stage-pipelined stream processing: host I/O overlapped with device DSP.

The reference decouples hardware I/O from demodulation with an RX worker
pthread + condvar handshake (/root/reference/lib/ofdmtxrx.cc:554-636).  The
equivalent here: a producer thread keeps a bounded queue of IQ blocks filled
(from a file via the native double-buffered reader, or any iterator) while
the consumer drives the jitted synchronizer step; JAX's async dispatch
overlaps the device work with the next block's host-side preparation, so
the handshake is simply the queue.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np


__all__ = ["BlockPrefetcher", "run_pipelined", "AsyncTxProducer"]


class BlockPrefetcher:
    """Producer thread filling a bounded block queue from an iterator."""

    def __init__(self, source: Iterable[np.ndarray], depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._src = iter(source)
        self._done = object()
        self._t = threading.Thread(target=self._fill, daemon=True)
        self._t.start()

    def _fill(self):
        try:
            for blk in self._src:
                self._q.put(blk)
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            # a source failure must reach the consumer, not end the
            # stream silently as if the capture were simply shorter
            self._q.put(("__error__", e))
        finally:
            self._q.put(self._done)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            item = self._q.get()
            if item is self._done:
                return
            if isinstance(item, tuple) and len(item) == 2 \
                    and item[0] == "__error__":
                raise item[1]
            yield item


def run_pipelined(source: Iterable[np.ndarray], step: Callable, state,
                  on_results: Callable | None = None, depth: int = 4,
                  block_size: int | None = None):
    """Drive ``step(state, block) -> (state, results)`` over a prefetched
    stream; returns the final state.

    ``source`` yields IQ blocks (ragged blocks are re-chunked to
    ``block_size`` when given); ``on_results`` receives each step's results
    while the next device step is already in flight (async dispatch).
    """
    def rechunk(it):
        if block_size is None:
            yield from it
            return
        buf = np.zeros(0, np.complex64)
        for blk in it:
            buf = np.concatenate([buf, np.asarray(blk)])
            while len(buf) >= block_size:
                yield buf[:block_size]
                buf = buf[block_size:]
        if len(buf):
            yield np.concatenate(
                [buf, np.zeros(block_size - len(buf), np.complex64)])

    import jax.numpy as jnp

    def stage(blk):
        # complex blocks go up as complex64; planes/wire-code arrays
        # ([2, ...] int8/int16/bf16) keep their dtype so iq_from_any
        # dequantizes them
        blk = np.asarray(blk)
        if np.iscomplexobj(blk):
            return jnp.asarray(blk, jnp.complex64)
        return jnp.asarray(blk)

    pending = None
    for blk in rechunk(BlockPrefetcher(source, depth)):
        state, results = step(state, stage(blk))
        if pending is not None and on_results is not None:
            on_results(pending)      # consume previous while device runs
        pending = results
    if pending is not None and on_results is not None:
        on_results(pending)
    return state


class AsyncTxProducer:
    """TX worker thread: packet submission decoupled from sample production.

    The reference's multichanneltxrx spawns a TX pthread that keeps
    generating samples ahead of the radio while ``transmit_packet`` merely
    stamps data into an idle framegen (lib/multichanneltxrx.cc:217-240,
    403-501).  Same shape here: :meth:`transmit_packet` enqueues work
    without blocking, and a worker thread keeps a bounded queue of
    generated sample blocks filled **ahead of the consumer's stream
    cursor** (idle channels produce zeros, exactly like the reference's
    worker).  All tx-object access happens on the worker thread.
    """

    _DONE = object()

    def __init__(self, tx, block_channel_samples: int = 256,
                 depth: int = 8):
        self._tx = tx
        self._block = block_channel_samples
        self._work: queue.Queue = queue.Queue()
        self._out: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._pending: list = []       # submitted but not yet stamped
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    # -- producer side (any thread) ---------------------------------------
    def transmit_packet(self, ch: int, header, payload, **props) -> None:
        """Non-blocking submit (the reference's transmit_packet)."""
        self._work.put((int(ch), np.asarray(header, np.uint8),
                        np.asarray(payload, np.uint8), props))

    def close(self) -> None:
        self._work.put(self._DONE)

    # -- worker ------------------------------------------------------------
    def _worker(self):
        tx = self._tx
        open_ = True
        while not self._stop.is_set():
            # pull new submissions (non-blocking once producing)
            while open_:
                try:
                    item = self._work.get_nowait()
                except queue.Empty:
                    break
                if item is self._DONE:
                    open_ = False
                    break
                self._pending.append(item)
            # stamp work onto ready channels
            still = []
            for ch, header, payload, props in self._pending:
                if tx.is_channel_ready(ch):
                    tx.update_data(ch, header, payload, **props)
                else:
                    still.append((ch, header, payload, props))
            self._pending = still
            idle = (not self._pending and
                    all(tx.is_channel_ready(c)
                        for c in range(tx.num_channels)))
            if not open_ and idle:
                # flush the synthesis filter memory (the reference's
                # end-of-burst drain, lib/multichanneltxrx.cc:478-494)
                taps = getattr(getattr(tx, "chz", None), "P", 0)
                if taps:
                    self._put(tx.generate_samples(2 * taps))
                self._put(self._DONE)
                return
            # generate ahead of the cursor (blocks when the queue is
            # full, but keeps checking the stop flag so stop() can
            # always unblock the thread)
            if self._put(tx.generate_samples(self._block)):
                return

    def _put(self, item) -> bool:
        """Bounded put that aborts on stop(); returns True when stopped."""
        while True:
            try:
                self._out.put(item, timeout=0.1)
                return False
            except queue.Full:
                if self._stop.is_set():
                    return True

    # -- consumer side ------------------------------------------------------
    def blocks(self) -> Iterator[np.ndarray]:
        """Yield generated sample blocks until the producer drains (or
        stop() interrupts it)."""
        while True:
            try:
                item = self._out.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set() and not self._t.is_alive():
                    return   # stopped with a full queue: no _DONE came
                continue
            if item is self._DONE:
                return
            yield item

    def queued_blocks(self) -> int:
        """Blocks currently generated ahead of the consumer."""
        return self._out.qsize()

    def stop(self):
        """Abandon production: unblocks a worker parked on the full
        output queue and terminates blocks() iteration (buffered blocks
        are drained first)."""
        self._stop.set()
        self._t.join(timeout=5.0)
        # wake any consumer blocked in blocks(): the worker may have
        # exited without enqueueing _DONE
        try:
            self._out.put_nowait(self._DONE)
        except queue.Full:
            pass
