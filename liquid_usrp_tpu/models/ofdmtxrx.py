"""ofdmtxrx — single-channel OFDM packet transceiver.

Capability parity with the reference's ``ofdmtxrx`` class
(/root/reference/include/ofdmtxrx.h, lib/ofdmtxrx.cc):

* ctor validates M>=8, cp>=1, taper<=cp (lib/ofdmtxrx.cc:60-69) and sets the
  default frame props CRC32 / none / Hamming(12,8) / QPSK (79-83) and radio
  defaults 462 MHz / 500 kS/s / -12 dB soft gain / 40 dB TX / 20 dB RX
  (100-108);
* ``set_tx_freq/rate/gain_soft/gain_uhd`` + rx equivalents (261-287,456-477);
* ``transmit_packet(header, payload, ms, fec0, fec1)`` (297-363) incl. the
  per-packet props override;
* symbol-granular TX: ``assemble_frame``/``write_symbol``/``end_transmit_
  frame`` (366-449);
* ``start_rx``/``stop_rx`` and a frame callback (486-508, 554-636).

Block-step redesign: UHD handles become IQ stream endpoints (arrays / files /
virtual air), the RX worker pthread becomes block-wise jitted sync steps
driven by :meth:`run_rx`, and the callback receives structured
:class:`FrameResults` rows instead of firing from a worker thread.  The
radio-parameter setters model the hardware state (frequency offsets between
TX and RX endpoints become CFO in the virtual channel).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from ..framing import ofdm, ofdm_sync
from ..framing import payload as payload_codec
from ..ops import fec as fec_mod
from ..ops import modem as modem_mod

__all__ = ["OfdmTxRx", "RadioConfig"]


@dataclass
class RadioConfig:
    """Virtual radio front-end state (the multi_usrp surface, SURVEY.md §2.4).

    Defaults mirror /root/reference/lib/ofdmtxrx.cc:100-108.
    """
    tx_freq: float = 462.0e6
    tx_rate: float = 500e3
    tx_gain_soft: float = -12.0   # dB
    tx_gain_uhd: float = 40.0     # dB (modelled as metadata only)
    rx_freq: float = 462.0e6
    rx_rate: float = 500e3
    rx_gain_uhd: float = 20.0
    tx_antenna: str = "TX/RX"     # metadata (set_tx_antenna surface)
    rx_antenna: str = "RX2"


class OfdmTxRx:
    """Single-channel OFDM packet transceiver over IQ stream endpoints."""

    def __init__(self, M: int = 48, cp_len: int = 6, taper_len: int = 4,
                 callback: Optional[Callable] = None,
                 block_size: int = 16384, max_payload: int = 2048,
                 rx_transform: Optional[Callable] = None,
                 batch_blocks: int = 8, rx_ingest: str = "c64",
                 enable_conv: bool = False, soft: bool = False,
                 expansion: int = payload_codec.EXPANSION):
        # ctor validation mirrors lib/ofdmtxrx.cc:60-69
        if M < 8:
            raise ValueError("number of subcarriers must be at least 8")
        if cp_len < 1:
            raise ValueError("cyclic prefix length must be at least 1")
        if taper_len > cp_len:
            raise ValueError("taper length cannot exceed cyclic prefix")
        self.params = ofdm.make_ofdm_params(M, cp_len, taper_len)
        self.props = ofdm.default_props()
        self.radio = RadioConfig()
        self.callback = callback
        self.expansion = int(expansion)
        self._sync = ofdm_sync.make_sync(self.params, block_size=block_size,
                                         max_payload=max_payload,
                                         enable_conv=enable_conv, soft=soft,
                                         expansion=self.expansion)
        self._step = ofdm_sync.make_sync_step(self._sync)
        self._rx_state = ofdm_sync.sync_init(self._sync)
        self._rx_running = False
        # multi-block batched dispatch (sync_blocks_batched): when a run_rx
        # call carries >= batch_blocks full blocks, they go to the device as
        # one vmapped dispatch instead of batch_blocks sequential steps —
        # same results (tested bit-identical), ~one dispatch's fixed cost
        self._batch_blocks = max(1, int(batch_blocks))
        self._bstep = None   # lazily jitted (compiles only if ever used)
        # pluggable mid-pipeline transform between recv and sync — the
        # functional replacement for the reference's blocking-RX 3-condvar
        # handshake that lets a third thread mutate the rx buffer
        # (/root/reference/lib/ofdmtxrx.cc:642-739)
        self.rx_transform = rx_transform
        # device-ingest format for RX blocks: "c64", "bf16" planes (half
        # the host->device transfer + input HBM read) or "sc8" int8 wire
        # codes (a quarter; ±127 ↔ ±1.0 ADC convention — the caller is
        # the AGC, out-of-range samples clip; ops/iqfmt.py)
        if rx_ingest not in ("c64", "bf16", "sc8"):
            raise ValueError(f"unknown rx_ingest {rx_ingest!r}")
        self.rx_ingest = rx_ingest
        self._tx_buffer: list[np.ndarray] = []
        # partial-frame assembly (write_symbol surface)
        self._assembled: Optional[np.ndarray] = None
        self._assembled_pos = 0

    # -- radio parameter surface (lib/ofdmtxrx.cc:261-287,456-477) ---------
    def set_tx_freq(self, f: float):
        self.radio.tx_freq = f

    def set_tx_rate(self, r: float):
        self.radio.tx_rate = r

    def set_tx_gain_soft(self, g_db: float):
        self.radio.tx_gain_soft = g_db

    def set_tx_gain_uhd(self, g_db: float):
        self.radio.tx_gain_uhd = g_db

    def set_rx_freq(self, f: float):
        self.radio.rx_freq = f

    def set_rx_rate(self, r: float):
        self.radio.rx_rate = r

    def set_rx_gain_uhd(self, g_db: float):
        self.radio.rx_gain_uhd = g_db

    def set_tx_antenna(self, name: str):
        self.radio.tx_antenna = name

    def set_rx_antenna(self, name: str):
        self.radio.rx_antenna = name

    # -- TX ----------------------------------------------------------------
    def set_properties(self, check=None, fec0=None, fec1=None, mod=None):
        """ofdmflexframegen_setprops surface (strings or enum ids)."""
        def res(v, cur, parser):
            if v is None:
                return cur
            return parser(v) if isinstance(v, str) else v
        self.props = ofdm.FrameProps(
            check=res(check, self.props.check,
                      lambda s: {"none": 0, "crc16": 1,
                                 "crc32": 2}[s.lower()]),
            fec0=res(fec0, self.props.fec0, fec_mod.fec_from_name),
            fec1=res(fec1, self.props.fec1, fec_mod.fec_from_name),
            mod=res(mod, self.props.mod, modem_mod.mod_from_name),
        )

    def transmit_packet(self, header, payload, mod=None, fec0=None,
                        fec1=None) -> np.ndarray:
        """Assemble + soft-gain a frame; returns (and queues) its samples.

        Mirrors ofdmtxrx::transmit_packet (lib/ofdmtxrx.cc:297-363): optional
        per-packet property overrides, then generate + scale by the soft
        gain.  The returned block is what the reference streams to UHD in
        256-sample chunks.
        """
        self.set_properties(fec0=fec0, fec1=fec1, mod=mod)
        header = jnp.asarray(np.asarray(header, dtype=np.uint8))
        payload = jnp.asarray(np.asarray(payload, dtype=np.uint8))
        g = 10.0 ** (self.radio.tx_gain_soft / 20.0)
        samples = ofdm.assemble_frame(
            self.params, self.props, header, payload,
            expansion=self.expansion,
            rx_max_payload=self._sync.max_payload) * g
        out = np.asarray(samples)
        self._tx_buffer.append(out)
        return out

    # symbol-granular variant (lib/ofdmtxrx.cc:366-449)
    def assemble_frame(self, header, payload, mod=None, fec0=None,
                       fec1=None):
        self.set_properties(fec0=fec0, fec1=fec1, mod=mod)
        g = 10.0 ** (self.radio.tx_gain_soft / 20.0)
        self._assembled = np.asarray(ofdm.assemble_frame(
            self.params, self.props,
            jnp.asarray(np.asarray(header, dtype=np.uint8)),
            jnp.asarray(np.asarray(payload, dtype=np.uint8)),
            expansion=self.expansion,
            rx_max_payload=self._sync.max_payload)) * g
        self._assembled_pos = 0

    def write_symbol(self) -> tuple[np.ndarray, bool]:
        """Next symbol-sized chunk of the assembled frame; (samples, last)."""
        if self._assembled is None:
            raise RuntimeError("no frame assembled")
        step = self.params.M + self.params.cp_len
        start = self._assembled_pos
        chunk = self._assembled[start:start + step]
        self._assembled_pos += len(chunk)
        last = self._assembled_pos >= len(self._assembled)
        if last:
            self._assembled = None
        return chunk, last

    def end_transmit_frame(self) -> np.ndarray:
        """Remaining samples of the assembled frame in one chunk (the
        drain loop of ofdmtxrx::end_transmit_frame,
        lib/ofdmtxrx.cc:437-449)."""
        if self._assembled is None:
            return np.zeros(0, dtype=np.complex64)
        rest = self._assembled[self._assembled_pos:]
        self._assembled = None
        return rest

    def reset_tx(self):
        """Drop queued packets + any partially-written assembled frame
        (ofdmtxrx::reset_tx, lib/ofdmtxrx.cc:290-294)."""
        self._tx_buffer = []
        self._assembled = None
        self._assembled_pos = 0

    def drain_tx(self) -> np.ndarray:
        """Concatenate and clear everything queued by transmit_packet."""
        if not self._tx_buffer:
            return np.zeros(0, dtype=np.complex64)
        out = np.concatenate(self._tx_buffer)
        self._tx_buffer = []
        return out

    # -- RX ----------------------------------------------------------------
    def start_rx(self):
        self._rx_running = True

    def stop_rx(self):
        self._rx_running = False

    def reset_rx(self):
        self._rx_state = ofdm_sync.sync_init(self._sync)

    # -- debug capture (ofdmtxrx::debug_enable/debug_disable,
    #    lib/ofdmtxrx.cc:233-242 -> ofdmflexframesync_debug_*) -------------
    def debug_enable(self):
        """Retain the most recent RX block for :meth:`debug_print`."""
        self._debug = True

    def debug_disable(self):
        self._debug = False
        self._debug_samples = None

    def debug_print(self, prefix: str) -> str:
        """Write the captured block + detection metric as an octave file
        (the ofdmflexframesync_debug_print surface); returns the path."""
        samples = getattr(self, "_debug_samples", None)
        if samples is None:
            raise RuntimeError("debug_enable() first, then run_rx()")
        metric = np.asarray(
            ofdm_sync._detect_metric(
                self._sync, jnp.asarray(samples, jnp.complex64))[0])
        path = f"{prefix}_framesync_debug.m"
        with open(path, "w") as f:
            f.write("%% ofdmtxrx debug capture (octave)\nclear all;\n")
            f.write("x = [" + " ".join(
                "(%.5g%+.5gj)" % (v.real, v.imag)
                for v in samples[:4096]) + "];\n")
            f.write("metric = [" + " ".join(
                "%.4f" % v for v in metric[:4096]) + "];\n")
            f.write("figure; subplot(2,1,1); plot(real(x)); ylabel('I'); "
                    "subplot(2,1,2); plot(metric); "
                    "ylabel('detect metric');\n")
        return path

    def _emit_rows(self, res_np, frames: list):
        """Turn one dispatch's host-side FrameResults into dict rows +
        callback deliveries.  ``res_np`` fields are [K, ...] numpy arrays."""
        for i in np.nonzero(res_np.detected)[0]:
            row = {
                "t": int(res_np.t_start[i]),
                "header": res_np.header[i],
                "header_valid": bool(res_np.header_valid[i]),
                "payload": res_np.payload[i][: int(res_np.payload_len[i])],
                "payload_valid": bool(res_np.payload_valid[i]),
                "payload_len": int(res_np.payload_len[i]),
                "stats": {
                    "rssi": float(res_np.rssi[i]),
                    "evm": float(res_np.evm[i]),
                    "cfo": float(res_np.cfo[i]),
                },
            }
            frames.append(row)
            if self.callback is not None:
                self.callback(
                    row["header"], row["header_valid"], row["payload"],
                    row["payload_len"], row["payload_valid"], row["stats"])

    def run_rx(self, samples: np.ndarray, flush: bool = False) -> list[dict]:
        """Feed IQ samples through the synchronizer; returns decoded frames.

        The block-based replacement for the RX worker thread + callback
        (lib/ofdmtxrx.cc:554-636): each decoded frame is delivered to the
        registered callback (if any) and returned as a dict row.  Runs of
        ``batch_blocks`` full blocks dispatch through
        :func:`ofdm_sync.sync_blocks_batched` (one fused device call) with a
        single device->host results transfer per dispatch.
        """
        if not self._rx_running:
            return []
        import jax

        bs = self._sync.block_size
        pending = getattr(self, "_pending", np.zeros(0, dtype=np.complex64))
        samples = np.concatenate([pending, np.asarray(samples)])
        if flush:
            pad = (-(-len(samples) // bs) + 1 +
                   self._sync.overlap // bs + 1) * bs - len(samples)
            samples = np.concatenate(
                [samples, np.zeros(pad, dtype=np.complex64)])
        n_blocks = len(samples) // bs
        nb = self._batch_blocks
        frames = []

        def to_dev(arr, shape):
            # arr: host complex64; shape: target block layout ([bs] or
            # [nb, bs]).  bf16 ingest ships [2, ...] planes instead —
            # half the host->device bytes + input HBM read; sc8 ships
            # int8 wire codes — a quarter (ops/iqfmt.py)
            if self.rx_ingest == "bf16":
                from ..io.native import cf32_to_bf16_planes
                return jnp.asarray(cf32_to_bf16_planes(arr.reshape(-1))
                                   .reshape((2,) + shape))
            if self.rx_ingest == "sc8":
                from ..io.native import cf32_to_sc8_planes
                return jnp.asarray(cf32_to_sc8_planes(arr.reshape(-1))
                                   .reshape((2,) + shape))
            return jnp.asarray(arr.reshape(shape), jnp.complex64)

        b = 0
        last_block = None
        while b < n_blocks:
            if n_blocks - b >= nb and nb > 1:
                chunk = samples[b * bs:(b + nb) * bs].reshape(nb, bs)
                if self.rx_transform is not None:
                    chunk = np.stack([np.asarray(
                        self.rx_transform(jnp.asarray(row, jnp.complex64)))
                        for row in chunk])
                if self._bstep is None:
                    sync = self._sync
                    self._bstep = jax.jit(
                        lambda st, blks: ofdm_sync.sync_blocks_batched(
                            sync, st, blks))
                self._rx_state, res = self._bstep(self._rx_state,
                                                  to_dev(chunk, (nb, bs)))
                res_np = jax.device_get(res)
                for j in range(nb):
                    self._emit_rows(
                        type(res_np)(*(f[j] for f in res_np)), frames)
                last_block = chunk[-1]
                b += nb
            else:
                blk = samples[b * bs:(b + 1) * bs]
                if self.rx_transform is not None:
                    blk = np.asarray(
                        self.rx_transform(jnp.asarray(blk, jnp.complex64)))
                self._rx_state, res = self._step(self._rx_state,
                                                 to_dev(blk, (bs,)))
                self._emit_rows(jax.device_get(res), frames)
                last_block = blk
                b += 1
        if getattr(self, "_debug", False) and last_block is not None:
            # retain the last block AS THE SYNCHRONIZER SAW IT (post
            # rx_transform) — the debug surface exists to diagnose
            # exactly the non-trivial ingest cases
            self._debug_samples = np.asarray(last_block).copy()
        self._pending = samples[n_blocks * bs:]
        return frames
