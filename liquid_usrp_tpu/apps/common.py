"""Shared app plumbing: getopt-compatible flags, radio-rate math, stats.

The reference apps share informal getopt conventions (SURVEY.md §5): ``f``
carrier freq, ``b`` bandwidth, ``g``/``G`` soft/hardware gain, ``M/C/T``
OFDM dims, ``m/c/k`` mod/inner-FEC/outer-FEC, ``t`` runtime, ``N`` frames,
``P`` payload bytes, ``n`` channels-or-payload, ``q/v`` quiet/verbose.
These are preserved; hardware I/O flags are joined by ``-o/-i`` IQ file
endpoints and ``--snr/--cfo`` virtual-channel impairments (the air
replacement; per BASELINE.json USRP I/O becomes file/synthetic streams).
"""
from __future__ import annotations

import getopt as _getopt
import sys

import numpy as np

from ..ops import fec as fec_mod
from ..ops import modem as modem_mod
from ..utils.compile_cache import enable_compile_cache

__all__ = ["parse_args", "print_usage_schemes", "RxStats", "apply_channel",
           "apply_msresamp", "iter_sync_results"]


def iter_sync_results(step, init_state, stream, block_size: int,
                      overlap: int, batched_fn=None, batch_blocks: int = 8):
    """Drive a synchronizer over a whole stream; yield per-block results.

    Pads ``stream`` with the flush tail (the carried overlap fully
    drains), then yields one result tuple per block (leading axis
    ``[max_frames]``) in stream order.  When ``batched_fn(state, blocks)``
    is given, runs of ``batch_blocks`` full blocks dispatch as ONE fused
    device call (the multi-block batched dispatch:
    ``*_sync_blocks_batched``) with a single device->host results
    transfer — replacing the reference's RX worker-thread pipelining
    (SURVEY.md §3) with device-level batching; leftover blocks fall back
    to the single-block ``step``.
    """
    import jax
    import jax.numpy as jnp
    bs = block_size
    flush = int(np.ceil(overlap / bs)) + 1
    total = (-(-len(stream) // bs) + flush) * bs
    stream = np.concatenate(
        [stream, np.zeros(total - len(stream), np.complex64)])
    n_blocks = total // bs
    state = init_state
    bstep = (jax.jit(batched_fn)
             if batched_fn is not None and batch_blocks > 1 else None)
    b = 0
    while b < n_blocks:
        if bstep is not None and n_blocks - b >= batch_blocks:
            chunk = stream[b * bs:(b + batch_blocks) * bs]
            state, res = bstep(state,
                               jnp.asarray(chunk.reshape(batch_blocks, bs)))
            res_np = jax.device_get(res)
            for j in range(batch_blocks):
                yield type(res_np)(*(f[j] for f in res_np))
            b += batch_blocks
        else:
            state, res = step(state, jnp.asarray(stream[b * bs:(b + 1) * bs]))
            yield jax.device_get(res)
            b += 1


def parse_args(argv, optstring: str, long_opts=None):
    """getopt wrapper returning (dict, positional).  Last flag wins.

    Unknown/malformed flags exit with a one-line error + a pointer to
    ``-h`` (liquid's getopt apps print usage and exit; a Python
    traceback is not an acceptable CLI failure mode).  Every app parses
    its flags here first, so this is also where the persistent compile
    cache is placed (``utils/compile_cache.py``)."""
    enable_compile_cache()
    try:
        opts, rest = _getopt.getopt(argv, optstring,
                                    long_opts or ["snr=", "cfo=", "delay=",
                                                  "seed="])
    except _getopt.GetoptError as e:
        print(f"error: {e} (use -h for usage)", file=sys.stderr)
        raise SystemExit(1)
    d = {}
    for k, v in opts:
        d[k.lstrip("-")] = v
    return d, rest


def budget_note(props, payload_len: int) -> int:
    """Auto-size the encode budget for the selected FEC pair and tell the
    user what receiver flags it needs.  Returns the expansion to
    assemble with (shared by the frame TX apps).

    ``--conv`` is advised only when a scheme is outside the base decode
    set (conv/RS branches are compile-heavy and otherwise useless);
    ``-e N`` only when the pair expands past the default budget.
    """
    from ..framing import payload as payload_codec
    exp = payload_codec.required_expansion(props, payload_len)
    need_conv = any(s not in payload_codec.PAYLOAD_FECS
                    for s in (props.fec0, props.fec1))
    flags = ([] if not need_conv else ["--conv"]) + \
        ([] if exp <= payload_codec.EXPANSION else [f"-e {exp}"])
    if flags:
        print(f"note: this FEC pair needs `{' '.join(flags)}` "
              f"on the receiver")
    return exp


def occupied_power(stream: np.ndarray) -> float:
    """Mean |x|^2 over the OCCUPIED samples (the frames, not the
    inter-frame zero gaps) — the SNR definition `--snr` calibrates
    against.  Whole-stream mean power dilutes by the idle fraction
    (~0.65 dB at default gaps, several dB for sparse captures), so the
    injected noise would miss the requested per-frame SNR.  Returns 1.0
    for empty/silent input (also avoids the NaN `np.mean([])`).
    """
    stream = np.asarray(stream)
    if not stream.size:
        return 1.0
    mag2 = np.abs(stream) ** 2
    floor = 1e-6 * float(mag2.max())
    occ = mag2[mag2 > floor]
    if not occ.size:
        return 1.0
    return float(np.mean(occ)) or 1.0


def print_usage_schemes(file=None):
    """List supported mod/FEC names (the liquid_print_*_schemes surface)."""
    file = file if file is not None else sys.stdout
    print("  modulation schemes:", " ".join(modem_mod.mod_names()),
          file=file)
    print("  FEC schemes:", " ".join(fec_mod.fec_names()), file=file)


def apply_channel(stream: np.ndarray, flags: dict, seed: int = 0,
                  signal_power: float = 1.0) -> np.ndarray:
    """Apply --snr/--cfo/--delay virtual-air impairments if requested."""
    snr = float(flags.get("snr", 1000.0))
    cfo = float(flags.get("cfo", 0.0))
    delay = int(flags.get("delay", 0))
    if snr >= 1000.0 and cfo == 0.0 and delay == 0:
        return stream
    import jax
    import jax.numpy as jnp
    from ..io.channel_model import Channel, channel_apply
    ch = Channel(snr_db=min(snr, 99.0), cfo=cfo, delay=delay)
    key = jax.random.PRNGKey(int(flags.get("seed", seed)))
    return np.asarray(channel_apply(ch, key, jnp.asarray(stream),
                                    signal_power=signal_power))


def apply_msresamp(stream: np.ndarray, rate: float) -> np.ndarray:
    """Resample a whole host-side stream through the streaming msresamp
    chain (the reference's recv -> msresamp -> measurement shape:
    /root/reference/src/rssi.cc:112,178, src/asgram_rx.cc:131,204).

    Chunked so decimation granularity (2**num_halfband) is respected and
    masked arb-stage outputs are compacted per chunk; rate 1.0 is the
    identity."""
    if rate == 1.0 or not len(stream):
        return stream
    import jax.numpy as jnp
    from ..ops import resamp as resamp_mod
    ms = resamp_mod.msresamp_create(rate)
    st = resamp_mod.msresamp_state(ms)
    gran = 2 ** ms.num_halfband if not ms.is_interp else 1
    chunk = -(-16384 // gran) * gran
    pad = (-len(stream)) % chunk
    x = np.concatenate([stream, np.zeros(pad, np.complex64)])
    outs = []
    for i in range(0, len(x), chunk):
        st, y, valid, count = resamp_mod.msresamp_block(
            ms, st, jnp.asarray(x[i:i + chunk]))
        outs.append(np.asarray(y)[:int(count)])
    out = np.concatenate(outs) if outs else np.zeros(0, np.complex64)
    # trim the resampled image of the padding tail
    return out[:int(round(len(stream) * rate))]


class RxStats:
    """Aggregate counters + the reference's end-of-run report format
    (/root/reference/src/ofdmflexframe_rx.cc:187-199)."""

    def __init__(self):
        self.num_frames_detected = 0
        self.num_valid_headers = 0
        self.num_valid_packets = 0
        self.num_bytes_received = 0

    def update(self, frame: dict):
        self.num_frames_detected += 1
        if frame["header_valid"]:
            self.num_valid_headers += 1
        if frame["payload_valid"]:
            self.num_valid_packets += 1
            self.num_bytes_received += frame["payload_len"]

    def report(self, runtime_s: float, file=None):
        file = file if file is not None else sys.stdout
        d = max(self.num_frames_detected, 1)
        print("    frames detected     : %6u" % self.num_frames_detected,
              file=file)
        print("    valid headers       : %6u (%6.2f%%)" %
              (self.num_valid_headers, 100.0 * self.num_valid_headers / d),
              file=file)
        print("    valid packets       : %6u (%6.2f%%)" %
              (self.num_valid_packets, 100.0 * self.num_valid_packets / d),
              file=file)
        print("    bytes received      : %6u" % self.num_bytes_received,
              file=file)
        print("    run time            : %f s" % runtime_s, file=file)
        if runtime_s > 0:
            print("    data rate           : %12.8f kbps" %
                  (8.0 * self.num_bytes_received / runtime_s * 1e-3),
                  file=file)


def dump_framesync_octave(path: str, title: str, stream: np.ndarray,
                          cap: dict) -> None:
    """Write one framesync debug capture as an executable octave script
    (the ofdmflexframesync_debug_print parity surface: raw IQ, detection
    metric, |H|, received constellation —
    /root/reference/lib/ofdmtxrx.cc:241-242,518-525)."""
    def cvec(f, name, vals, limit=4096):
        f.write(name + " = [" + " ".join(
            "(%.5g%+.5gj)" % (v.real, v.imag) for v in vals[:limit])
            + "];\n")

    with open(path, "w") as f:
        f.write("%% " + title + " (octave)\nclear all;\n")
        f.write("%% strongest candidate: n0=%d detected=%d hdr_valid=%d "
                "cfo=%.6f rssi=%.1f dB\n" %
                (cap["n0"], cap["detected"], cap["header_valid"],
                 cap["cfo"], cap["rssi"]))
        cvec(f, "x", stream[:4096])
        f.write("metric = [" + " ".join(
            "%.4f" % v
            for v in cap["metric"][: min(len(cap["metric"]), 4096)])
            + "];\n")
        cvec(f, "H", cap["H"])               # channel estimate [M]
        cvec(f, "syms_hdr", cap["hsyms_eq"])    # equalized header points
        cvec(f, "syms_pay", cap["psyms_eq"])    # equalized payload points
        f.write(
            "figure;\n"
            "subplot(2,2,1); plot(real(x)); ylabel('I');\n"
            "subplot(2,2,2); plot(metric); ylabel('detect metric');\n"
            "subplot(2,2,3); plot(20*log10(max(abs(H),1e-6))); "
            "ylabel('|H| dB'); xlabel('subcarrier');\n"
            "subplot(2,2,4); plot(real(syms_pay), imag(syms_pay), 'x', "
            "real(syms_hdr), imag(syms_hdr), '.'); axis square; "
            "xlabel('I'); ylabel('Q'); title('received constellation');\n")
