"""OFDM flexible framing — shared format definition + frame generator (TX).

Capability parity: ``ofdmflexframegen`` — M-subcarrier OFDM frames with S0/S1
preamble, FEC+CRC protected header, per-packet runtime-settable payload
modulation/FEC, cyclic prefix and taper (/root/reference/lib/ofdmtxrx.cc:
79-88,293,317-328 uses assemble/write; /root/reference/lib/multichanneltx.cc:
70-82,184-188 drives one per channel).  Frame defaults in the apps: M=48,
cp=6, taper=4, QPSK, CRC32, Golay(24,12) (/root/reference/src/
ofdmflexframe_tx.cc:57-72).

This is a from-scratch frame format engineered for batched device generation
and synchronization (NOT liquid-dsp's wire format — the reference never
exposes that format off-air, only its capabilities):

* preamble: 2 short-sync symbols ``S0`` (energy on every 4th subcarrier ->
  period-M/4 time structure for detection + coarse CFO), then 1 long-sync
  symbol ``S1`` (full-band PN BPSK for fine timing + channel estimation);
  all preamble symbols are M samples, no CP.
* header: 8 user bytes + [payload_len u16 | mod u8 | fec0 u8 | fec1 u8 |
  check u8] + CRC16, Golay(24,12) encoded, BPSK on the data subcarriers.
* payload: payload -> CRC(check) -> inner FEC (fec0) -> outer FEC (fec1) ->
  modem symbols -> data subcarriers.  Pilot subcarriers carry a per-symbol
  PN-rotated BPSK sequence for common-phase/timing tracking.
* every data symbol is IFFT(M) + cyclic prefix with a raised-cosine taper on
  the first ``taper_len`` CP samples.

TX is one fused batched graph: all OFDM symbols IFFT'd at once, CP/taper via
slicing — no per-symbol loop (the reference emits symbol-by-symbol,
/root/reference/lib/ofdmtxrx.cc:325-342).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import crc as crc_mod
from ..ops import fec as fec_mod
from ..ops import modem as modem_mod
from ..utils.bits import pack_bits, unpack_bits
from . import payload as payload_codec
from .payload import (HEADER_BPS as _HEADER_BPS,
                      HEADER_MOD as _HEADER_MOD,
                      HEADER_SYMS, HEADER_USER_BYTES)

__all__ = [
    "OfdmParams", "FrameProps", "make_ofdm_params", "default_props",
    "assemble_frame", "assemble_frames", "frame_length",
    "payload_symbol_count",
    "HEADER_USER_BYTES",
    "SCTYPE_NULL", "SCTYPE_PILOT", "SCTYPE_DATA",
]

NUM_S0 = 2                     # short-sync preamble symbols
MAX_PAYLOAD = 4096             # bytes; >> any reference default (1200)


class OfdmParams(NamedTuple):
    """Static frame format description (all host-side constants)."""
    M: int
    cp_len: int
    taper_len: int
    # subcarrier maps, FFT-order indices
    data_idx: np.ndarray       # [n_data] int
    pilot_idx: np.ndarray      # [n_pilot] int
    null_idx: np.ndarray       # [n_null] int
    s0_freq: np.ndarray        # [M] complex64 S0 frequency-domain symbol
    s1_freq: np.ndarray        # [M] complex64 S1 frequency-domain symbol
    s0_time: np.ndarray        # [M] complex64 (unit average power)
    s1_time: np.ndarray        # [M] complex64
    pilot_base: np.ndarray     # [n_pilot] float (+-1 BPSK per pilot carrier)
    pilot_pn: np.ndarray       # [127] float (+-1 per-symbol rotation PN)
    taper_win: np.ndarray      # [taper_len] float raised-cosine ramp


class FrameProps(NamedTuple):
    """Per-packet properties (the ofdmflexframegenprops surface:
    check/fec0/fec1/mod_scheme, /root/reference/include/ofdmtxrx.h)."""
    check: int = crc_mod.CRC_32
    fec0: int = fec_mod.FEC_NONE
    fec1: int = fec_mod.FEC_HAMMING128
    mod: int = modem_mod.MOD_QPSK


def default_props() -> FrameProps:
    """Library defaults (/root/reference/lib/ofdmtxrx.cc:79-83)."""
    return FrameProps()


def default_subcarrier_allocation(M: int):
    """Deterministic default allocation: DC null, ~10% edge guards, pilots
    every 7th active carrier (mirrors the reference default's structure)."""
    guard = max(1, int(round(M * 0.1)))
    null = {0}
    for g in range(-guard + 1, guard):
        null.add((M // 2 + g) % M)
    active = [k for k in range(M) if k not in null]
    # order active carriers by physical frequency (negative..positive)
    def freq_order(k):
        return k - M if k > M // 2 else k
    active_sorted = sorted(active, key=freq_order)
    pilots = set(active_sorted[::7])
    data = [k for k in active if k not in pilots]
    if len(pilots) < 2:
        raise ValueError("M too small for pilot allocation")
    return (np.array(sorted(data)), np.array(sorted(pilots)),
            np.array(sorted(null)))


# per-subcarrier type codes (the liquid OFDMFRAME_SCTYPE_* surface for
# the ofdmflexframegen_create(M, cp, taper, p, ...) allocation vector)
SCTYPE_NULL = 0
SCTYPE_PILOT = 1
SCTYPE_DATA = 2


def make_ofdm_params(M: int = 64, cp_len: int = 16,
                     taper_len: int = 4, alloc=None) -> OfdmParams:
    """Build OFDM frame parameters.

    ``alloc``: optional length-M per-subcarrier type vector
    (``SCTYPE_NULL``/``SCTYPE_PILOT``/``SCTYPE_DATA``) — the custom
    subcarrier-allocation surface of ``ofdmflexframegen_create``'s ``p``
    argument; ``None`` selects the deterministic default allocation
    (what the reference passes, lib/ofdmtxrx.cc:86-88).
    """
    if alloc is not None:
        alloc = tuple(int(v) for v in np.asarray(alloc).ravel())
    return _make_ofdm_params(M, cp_len, taper_len, alloc)


@functools.lru_cache(maxsize=None)
def _make_ofdm_params(M: int, cp_len: int, taper_len: int,
                      alloc) -> OfdmParams:
    if M < 8:
        raise ValueError("number of subcarriers must be at least 8")
    if M % 4:
        # the S0 detector relies on the exact period-M/4 time structure of
        # the short-sync symbol (energy on every 4th subcarrier); an M that
        # is not a multiple of 4 builds frames the synchronizer cannot
        # reliably detect.  All reference configs use multiples of 4.
        raise ValueError("number of subcarriers must be a multiple of 4")
    if not (0 < cp_len <= M):
        raise ValueError("cyclic prefix must be in (0, M]")
    if taper_len > cp_len:
        raise ValueError("taper length cannot exceed cyclic prefix")
    if alloc is None:
        if M < 12:
            # the M>=8 ctor check matches the reference's message, but
            # the default allocation needs >= 2 pilots among the active
            # carriers, which M=8 cannot provide; smaller grids need a
            # custom alloc
            raise ValueError(
                "default subcarrier allocation needs M >= 12 (only one "
                "pilot fits at M=8); pass a custom alloc= with >= 2 "
                "pilots for smaller grids")
        data_idx, pilot_idx, null_idx = default_subcarrier_allocation(M)
    else:
        # validation mirrors ofdmframe_validate_sctype semantics
        if len(alloc) != M:
            raise ValueError(f"allocation must have M={M} entries")
        a = np.asarray(alloc)
        if not np.isin(a, (SCTYPE_NULL, SCTYPE_PILOT, SCTYPE_DATA)).all():
            raise ValueError("allocation entries must be SCTYPE_NULL/"
                             "PILOT/DATA (0/1/2)")
        data_idx = np.nonzero(a == SCTYPE_DATA)[0]
        pilot_idx = np.nonzero(a == SCTYPE_PILOT)[0]
        null_idx = np.nonzero(a == SCTYPE_NULL)[0]
        if len(pilot_idx) < 2:
            raise ValueError("allocation needs at least 2 pilot "
                             "subcarriers (CPE slope tracking)")
        if len(data_idx) < 1:
            raise ValueError("allocation needs at least 1 data subcarrier")
        # S0 lives on every 4th non-null subcarrier: without enough of
        # them the period-M/4 detection metric has no signal to lock on
        n_s0 = sum(1 for k in range(0, M, 4) if a[k] != SCTYPE_NULL)
        if n_s0 < 2:
            raise ValueError("allocation nulls (almost) every 4th "
                             "subcarrier — the S0 detector needs >= 2 "
                             "active multiples-of-4")
    rng = np.random.default_rng(0x5EED0FD + M)

    # S0: PN QPSK on every 4th active subcarrier, boosted to unit time power
    s0 = np.zeros(M, dtype=np.complex128)
    s0_set = [k for k in range(0, M, 4)
              if k not in set(null_idx.tolist())]
    ph = rng.integers(0, 4, size=len(s0_set))
    s0[s0_set] = np.exp(1j * (np.pi / 2 * ph + np.pi / 4))
    s0 *= np.sqrt(M / max(len(s0_set), 1))       # unit avg power in time
    s0_time = np.fft.ifft(s0) * np.sqrt(M)       # scaled so E|s0_time|^2 ~ 1

    # S1: PN BPSK on all active subcarriers
    s1 = np.zeros(M, dtype=np.complex128)
    act = sorted(set(range(M)) - set(null_idx.tolist()))
    s1[act] = rng.integers(0, 2, size=len(act)) * 2.0 - 1.0
    s1 *= np.sqrt(M / len(act))
    s1_time = np.fft.ifft(s1) * np.sqrt(M)

    pilot_base = rng.integers(0, 2, size=len(pilot_idx)) * 2.0 - 1.0
    pilot_pn = rng.integers(0, 2, size=127) * 2.0 - 1.0

    t = np.arange(taper_len) + 1.0
    taper_win = 0.5 * (1.0 - np.cos(np.pi * t / (taper_len + 1)))

    return OfdmParams(
        M=M, cp_len=cp_len, taper_len=taper_len,
        data_idx=data_idx, pilot_idx=pilot_idx, null_idx=null_idx,
        s0_freq=s0.astype(np.complex64), s1_freq=s1.astype(np.complex64),
        s0_time=s0_time.astype(np.complex64),
        s1_time=s1_time.astype(np.complex64),
        pilot_base=pilot_base.astype(np.float32),
        pilot_pn=pilot_pn.astype(np.float32),
        taper_win=taper_win.astype(np.float32),
    )


# ---------------------------------------------------------------------------
# frame geometry
# ---------------------------------------------------------------------------

def payload_enc_bytes(props: FrameProps, payload_len: int) -> int:
    return payload_codec.payload_enc_bytes(props, payload_len)


def payload_symbol_count(params: OfdmParams, props: FrameProps,
                         payload_len: int) -> int:
    """Number of payload OFDM symbols."""
    n_data = len(params.data_idx)
    bps = modem_mod.bits_per_symbol(props.mod)
    n_mod = -(-payload_enc_bytes(props, payload_len) * 8 // bps)
    if modem_mod.is_differential(props.mod):
        n_mod += 1            # leading DPSK phase-reference point
    return -(-n_mod // n_data)


def header_symbol_count(params: OfdmParams) -> int:
    return -(-HEADER_SYMS // len(params.data_idx))


def frame_length(params: OfdmParams, props: FrameProps,
                 payload_len: int) -> int:
    """Total samples in an assembled frame."""
    M, cp = params.M, params.cp_len
    n_sym = header_symbol_count(params) + payload_symbol_count(
        params, props, payload_len)
    return (NUM_S0 + 1) * M + n_sym * (M + cp)


# ---------------------------------------------------------------------------
# TX
# ---------------------------------------------------------------------------

def _pilot_values(params: OfdmParams, sym_indices: jnp.ndarray) -> jnp.ndarray:
    """Pilot BPSK values for given absolute data-symbol indices: [n_sym, n_pilot]."""
    pn = jnp.asarray(params.pilot_pn)[sym_indices % params.pilot_pn.shape[0]]
    return pn[:, None] * jnp.asarray(params.pilot_base)[None, :]


def _ofdm_modulate(params: OfdmParams, freq_syms: jnp.ndarray) -> jnp.ndarray:
    """Frequency-domain symbols [n_sym, M] -> time samples [n_sym*(M+cp)]
    with CP + taper."""
    M, cp, tp = params.M, params.cp_len, params.taper_len
    time_syms = jnp.fft.ifft(freq_syms, axis=-1).astype(jnp.complex64) * \
        jnp.sqrt(jnp.float32(M))
    with_cp = jnp.concatenate([time_syms[:, M - cp:], time_syms], axis=-1)
    if tp > 0:
        win = jnp.concatenate([
            jnp.asarray(params.taper_win),
            jnp.ones(M + cp - tp, dtype=jnp.float32)])
        with_cp = with_cp * win[None, :].astype(with_cp.dtype)
    return with_cp.reshape(-1)


def _encode_header(header: jnp.ndarray, payload_len: int,
                   props: FrameProps) -> jnp.ndarray:
    return payload_codec.encode_header(header, payload_len, props)


def _symbols_to_grid(params: OfdmParams, mod_syms: jnp.ndarray,
                     n_ofdm_syms: int, first_sym_index: int) -> jnp.ndarray:
    """Pack modem symbols onto the data carriers of ``n_ofdm_syms`` OFDM
    symbols (zero-padding the tail), add pilots -> [n_ofdm_syms, M] freq grid."""
    M = params.M
    n_data = len(params.data_idx)
    total = n_ofdm_syms * n_data
    pad = total - mod_syms.shape[-1]
    syms = jnp.concatenate(
        [mod_syms, jnp.zeros((pad,), dtype=mod_syms.dtype)])
    grid = jnp.zeros((n_ofdm_syms, M), dtype=jnp.complex64)
    grid = grid.at[:, jnp.asarray(params.data_idx)].set(
        syms.reshape(n_ofdm_syms, n_data))
    sym_idx = first_sym_index + jnp.arange(n_ofdm_syms)
    grid = grid.at[:, jnp.asarray(params.pilot_idx)].set(
        _pilot_values(params, sym_idx).astype(jnp.complex64))
    return grid


def assemble_frame(params: OfdmParams, props: FrameProps,
                   header: jnp.ndarray, payload: jnp.ndarray,
                   expansion: int = payload_codec.EXPANSION,
                   rx_max_payload: int = None) -> jnp.ndarray:
    """Assemble a complete frame -> complex64 ``[frame_length]``.

    ``header``: uint8 [8]; ``payload``: uint8 [payload_len] (static length).
    Matches ``ofdmflexframegen_assemble`` + drain-all-symbols semantics
    (/root/reference/lib/ofdmtxrx.cc:320-342) in one batched graph.
    ``expansion``/``rx_max_payload`` describe the receiving sync's decode
    budget (see payload.check_budget).
    """
    payload_len = payload.shape[-1]
    payload_codec.check_budget(props, payload_len, expansion,
                               rx_max_payload)
    # --- header ---
    henc = _encode_header(header, payload_len, props)
    hbits = unpack_bits(henc)
    pad = HEADER_SYMS * _HEADER_BPS - hbits.shape[-1]
    hbits = jnp.concatenate([hbits, jnp.zeros(pad, dtype=hbits.dtype)])
    hsyms = modem_mod.modulate(
        _HEADER_MOD, modem_mod.bits_to_symbols(hbits, _HEADER_BPS))
    n_hsym = header_symbol_count(params)
    # --- payload ---
    enc = payload_codec.encode_payload(props, payload)
    bps = modem_mod.bits_per_symbol(props.mod)
    pbits = unpack_bits(enc)
    n_mod = -(-pbits.shape[-1] // bps)
    pad = n_mod * bps - pbits.shape[-1]
    if pad:
        pbits = jnp.concatenate([pbits, jnp.zeros(pad, dtype=pbits.dtype)])
    psyms = modem_mod.modulate(props.mod,
                               modem_mod.bits_to_symbols(pbits, bps))
    if modem_mod.is_differential(props.mod):
        # DPSK: symbols are phase increments on a cumulative rotation led
        # by a unit reference point (liquid modem semantics)
        psyms = payload_codec.diff_encode_points(psyms)
    n_psym = payload_symbol_count(params, props, payload_len)
    # --- grids & time-domain ---
    hgrid = _symbols_to_grid(params, hsyms, n_hsym, 0)
    pgrid = _symbols_to_grid(params, psyms, n_psym, n_hsym)
    body = _ofdm_modulate(params, jnp.concatenate([hgrid, pgrid], axis=0))
    preamble = jnp.concatenate([
        jnp.tile(jnp.asarray(params.s0_time), NUM_S0),
        jnp.asarray(params.s1_time)])
    return jnp.concatenate([preamble, body])


def assemble_frames(params: OfdmParams, props: FrameProps,
                    headers: jnp.ndarray, payloads: jnp.ndarray,
                    expansion: int = payload_codec.EXPANSION,
                    rx_max_payload: int = None):
    """Batched assembly: ``[B, 8]`` headers + ``[B, P]`` payloads ->
    ``[B, frame_length]``.

    The frame-batch (DP) axis of SURVEY.md §2.2: frames are independent
    given per-frame params, so a whole batch is generated in one vmapped
    graph and the batch axis shards across devices for throughput.
    ``expansion``/``rx_max_payload`` forward to the per-frame budget
    check (same contract as :func:`assemble_frame`).
    """
    return jax.vmap(lambda h, p: assemble_frame(
        params, props, h, p, expansion=expansion,
        rx_max_payload=rx_max_payload))(headers, payloads)
