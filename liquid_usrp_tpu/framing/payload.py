"""Shared payload/header codec for all frame families.

Every reference framer (ofdmflexframe, flexframe, gmskframe, frame64) shares
the same packet shape: FEC+CRC protected header carrying per-packet payload
properties, then a payload run through CRC -> inner FEC -> outer FEC ->
modem (SURVEY.md §2.3).  This module holds the device-side codec used by
all of them:

* static header encode/decode (Golay(24,12) + CRC16 + PN scramble),
* runtime-property payload decode: constellation selected by a traced enum
  via a padded-table gather, FEC via ``lax.switch`` over the scheme set on
  static max-size buffers, CRC over a traced length.

Factoring it here keeps each synchronizer to its modulation-specific front
end (OFDM grid EQ / single-carrier matched filter / GMSK phase demod).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import crc as crc_mod
from ..ops import fec as fec_mod
from ..ops import modem as modem_mod
from ..utils.bits import pack_bits, unpack_bits

__all__ = [
    "PAYLOAD_FECS", "PAYLOAD_FECS_FULL", "PAYLOAD_MODS",
    "HEADER_USER_BYTES",
    "HEADER_DEC_BYTES", "HEADER_ENC_BYTES", "HEADER_MOD", "HEADER_BPS",
    "HEADER_SYMS", "header_dec_bytes", "header_enc_bytes", "header_syms",
    "scramble", "encode_header", "decode_header",
    "decode_header_soft",
    "encode_payload", "payload_enc_bytes", "check_budget",
    "required_expansion",
    "generic_demod_bits", "fec_decode_switch", "crc_check_dynamic",
    "EXPANSION",
]

# payload schemes decodable at runtime (order = lax.switch branch index =
# scheme id, so the tuples below are prefixes of the full enum)
PAYLOAD_FECS = (
    fec_mod.FEC_NONE, fec_mod.FEC_REP3, fec_mod.FEC_REP5,
    fec_mod.FEC_HAMMING74, fec_mod.FEC_HAMMING84, fec_mod.FEC_HAMMING128,
    fec_mod.FEC_GOLAY2412, fec_mod.FEC_SECDED2216, fec_mod.FEC_SECDED3932,
    fec_mod.FEC_SECDED7264,
)
# extended set incl. Viterbi + RS branches (compile-heavier; opt-in per
# sync).  Must stay an id-ordered prefix of the scheme enum.
PAYLOAD_FECS_FULL = PAYLOAD_FECS + (fec_mod.FEC_CONV_V27,
                                    fec_mod.FEC_CONV_V29, fec_mod.FEC_RS8)
PAYLOAD_MODS = tuple(range(50))     # every modem scheme id
EXPANSION = 3                       # worst supported FEC expansion budget
_MAX_CONST = 256
# differential schemes (dpsk2/4/8): symbols ride phase *increments*, with
# one known reference point leading the payload stream (liquid modem
# semantics, /root/reference/src/narrowband_tx.cc:153-154)
_IS_DIFF = np.array([modem_mod.is_differential(s) for s in PAYLOAD_MODS])

HEADER_USER_BYTES = 8               # reference: p_id + 6 random bytes
# Golay(24,12) + BPSK header: ~4 dB more sensitive than Hamming(12,8)+QPSK
# for ~9% frame overhead — the header is the end-to-end waterfall limiter
HEADER_FEC = fec_mod.FEC_GOLAY2412
HEADER_MOD = modem_mod.MOD_BPSK
HEADER_BPS = 1


# The user-header length is per-family configurable (the reference's
# flexframe apps carry a 14-byte user header, /root/reference/src/
# flexframe_tx.cc:176, while ofdmflexframe/gmskframe use 8).  All header
# layout sizes derive from it:

def header_dec_bytes(user_bytes: int = HEADER_USER_BYTES) -> int:
    """user bytes + [len u16 | mod | fec0 | fec1 | check] + CRC16."""
    return user_bytes + 6 + 2


def header_enc_bytes(user_bytes: int = HEADER_USER_BYTES) -> int:
    return fec_mod.encoded_length(HEADER_FEC, header_dec_bytes(user_bytes))


def header_syms(user_bytes: int = HEADER_USER_BYTES) -> int:
    return (header_enc_bytes(user_bytes) * 8 + HEADER_BPS - 1) // HEADER_BPS


# default-8 instances (the ofdm/gmsk families and the wire format of
# every artifact recorded before header lengths became configurable)
HEADER_DEC_BYTES = header_dec_bytes()
HEADER_ENC_BYTES = header_enc_bytes()
HEADER_SYMS = header_syms()


@functools.lru_cache(maxsize=None)
def _scramble_np(n: int, salt: int) -> np.ndarray:
    """Deterministic PN byte sequence (whitens frames; kills the all-zero
    degenerate decode, like liquid's packetizer scrambler)."""
    rng = np.random.default_rng(0x5C4A3B1E + salt)
    return rng.integers(0, 256, size=n, dtype=np.uint8)


def scramble(data: jnp.ndarray, salt: int = 0) -> jnp.ndarray:
    """XOR with the PN sequence (involutive)."""
    return data ^ jnp.asarray(_scramble_np(data.shape[-1], salt))


@functools.lru_cache(maxsize=None)
def _stacked_tables() -> np.ndarray:
    tabs = np.full((len(PAYLOAD_MODS), _MAX_CONST), 1e6 + 0j,
                   dtype=np.complex64)
    for s in PAYLOAD_MODS:
        t = modem_mod._table_np(s)
        tabs[s, : len(t)] = t.astype(np.complex64)
    return tabs


# ---------------------------------------------------------------------------
# header
# ---------------------------------------------------------------------------

def encode_header(header: jnp.ndarray, payload_len: int, props) -> jnp.ndarray:
    """User bytes (length = the family's static user-header size) +
    [len u16 | mod | fec0 | fec1 | check] -> encoded (scrambled) header
    bytes.  All layout sizes derive from ``header.shape[-1]``."""
    internal = jnp.asarray([
        (payload_len >> 8) & 0xFF, payload_len & 0xFF,
        props.mod & 0xFF, props.fec0 & 0xFF, props.fec1 & 0xFF,
        props.check & 0xFF], dtype=jnp.uint8)
    dec = jnp.concatenate([header.astype(jnp.uint8), internal])
    dec = crc_mod.crc_append(crc_mod.CRC_16, dec)
    return scramble(fec_mod.fec_encode(HEADER_FEC, dec), salt=1)


def decode_header(hbytes: jnp.ndarray, max_payload: int,
                  n_fecs: int = len(PAYLOAD_FECS),
                  user_bytes: int = HEADER_USER_BYTES):
    """Encoded header bytes -> (user, plen, mod, f0, f1, check, valid).

    Field values are clamped into range so they are safe as traced indices
    even when ``valid`` is False.
    """
    dec = fec_mod.fec_decode(HEADER_FEC, scramble(hbytes, salt=1),
                             header_dec_bytes(user_bytes))
    return _header_fields(dec, max_payload, n_fecs, user_bytes)


def decode_header_soft(hllrs: jnp.ndarray, max_payload: int,
                       n_fecs: int = len(PAYLOAD_FECS),
                       user_bytes: int = HEADER_USER_BYTES):
    """Soft-decision header decode from channel bit LLRs.

    ``hllrs [>= HEADER_ENC_BYTES*8]`` float LLRs of the header bit stream
    (positive => bit 1, the :func:`generic_demod_soft` layout).  The
    scrambler is undone by flipping LLR signs where the PN bit is 1, then
    each Golay(24,12) block is exact-ML decoded against all 4096
    codewords (one matmul — ``ops.fec.golay_decode_soft``).  Same returns
    as :func:`decode_header`; worth ~2 dB of header sensitivity, which is
    the end-to-end waterfall at low SNR once payload FEC is strong (the
    conv-coded GMSK/flex/ofdm configs).
    """
    enc_b = header_enc_bytes(user_bytes)
    dec_b = header_dec_bytes(user_bytes)
    need = enc_b * 8
    pn = np.unpackbits(_scramble_np(enc_b, 1)).astype(np.float32)
    L = hllrs[:need] * jnp.asarray(1.0 - 2.0 * pn)
    c_k, c_n = 12, 24
    nblocks = -(-(dec_b * 8) // c_k)
    mbits = fec_mod.golay_decode_soft(
        L[: nblocks * c_n].reshape(nblocks, c_n))
    dec = pack_bits(mbits.reshape(-1)[: dec_b * 8])
    return _header_fields(dec, max_payload, n_fecs, user_bytes)


def _header_fields(dec: jnp.ndarray, max_payload: int, n_fecs: int,
                   user_bytes: int = HEADER_USER_BYTES):
    ok = crc_mod.crc_check(crc_mod.CRC_16, dec)
    user = dec[:user_bytes]
    plen = (dec[user_bytes].astype(jnp.int32) << 8) | \
        dec[user_bytes + 1].astype(jnp.int32)
    mod = dec[user_bytes + 2].astype(jnp.int32)
    f0 = dec[user_bytes + 3].astype(jnp.int32)
    f1 = dec[user_bytes + 4].astype(jnp.int32)
    check = dec[user_bytes + 5].astype(jnp.int32)
    valid = ok & (mod < len(PAYLOAD_MODS)) & \
        (f0 < n_fecs) & (f1 < n_fecs) & \
        (check <= 2) & (plen <= max_payload)
    return (user, jnp.clip(plen, 0, max_payload),
            jnp.clip(mod, 0, len(PAYLOAD_MODS) - 1),
            jnp.clip(f0, 0, n_fecs - 1),
            jnp.clip(f1, 0, n_fecs - 1),
            jnp.clip(check, 0, 2), valid)


def header_bits_to_bytes(hbits: jnp.ndarray,
                         user_bytes: int = HEADER_USER_BYTES) -> jnp.ndarray:
    """Demodulated header bit stream -> encoded header byte buffer."""
    need = header_enc_bytes(user_bytes) * 8
    if hbits.shape[-1] < need:
        hbits = jnp.concatenate([
            hbits, jnp.zeros(need - hbits.shape[-1], dtype=jnp.uint8)])
    return pack_bits(hbits[:need])


# ---------------------------------------------------------------------------
# payload
# ---------------------------------------------------------------------------

def payload_enc_bytes(props, payload_len: int) -> int:
    n = payload_len + crc_mod.crc_width_bytes(props.check)
    n = fec_mod.encoded_length(props.fec0, n)
    n = fec_mod.encoded_length(props.fec1, n)
    return n


def required_expansion(props, payload_len: int) -> int:
    """Smallest ``expansion`` budget that fits this props combination for
    ANY conforming receiver (worst case ``max_payload == payload_len``).

    Both ends must be built for it when it exceeds the default
    ``EXPANSION``: ``make_*_sync(expansion=n)`` and
    ``assemble(..., expansion=n)``.  Apps use this to auto-size the TX
    budget and tell the user what to pass to the receiver.
    """
    dec = payload_len + 4            # the sync dec_max formula (CRC32 allowance)
    need = payload_enc_bytes(props, payload_len)
    return max(EXPANSION, -(-need // max(dec, 1)))


def check_budget(props, payload_len: int, expansion: int = EXPANSION,
                 rx_max_payload: int = None):
    """Raise if this mod/FEC combination overflows the RX decode budget.

    The synchronizers decode payloads into static buffers of
    ``expansion * (max_payload + 4)`` bytes (``make_*_sync``).  A frame
    whose encoded payload exceeds that (e.g. v27's rate-1/2 on top of the
    default Hamming(12,8) outer = 3.01x, at full payload size) would
    silently truncate the encoded tail — the trailing CRC bytes decode as
    garbage and every frame fails validation even at high SNR.  Fail
    loudly at assemble time instead.

    ``rx_max_payload``: the receiving sync's ``max_payload`` when known
    (e.g. a paired transceiver) — a frame shorter than the receiver's
    budget has headroom.  Defaults to the conservative worst case
    ``max_payload == payload_len`` (safe for ANY receiver that can hold
    the payload at all).
    """
    if expansion < 1:
        raise ValueError(f"expansion must be >= 1 (got {expansion})")
    if rx_max_payload is not None and payload_len > rx_max_payload:
        raise ValueError(
            f"{payload_len}-byte payload exceeds the receiver's "
            f"max_payload={rx_max_payload} — it would transmit but the "
            f"decoded header's length field fails validation on every "
            f"frame")
    rx_max = payload_len if rx_max_payload is None else rx_max_payload
    need = payload_enc_bytes(props, payload_len)
    budget = expansion * (rx_max + 4)
    if need > budget:
        raise ValueError(
            f"fec0={fec_mod.fec_name(props.fec0)} + "
            f"fec1={fec_mod.fec_name(props.fec1)} encodes a "
            f"{payload_len}-byte payload to {need} bytes — beyond the "
            f"expansion={expansion} receive budget of {budget} bytes "
            f"(max_payload={rx_max}).  Build both ends for it: "
            f"make_*_sync(..., expansion=<n>) and "
            f"assemble(..., expansion=<n>), or pick a lighter outer FEC "
            f"(the reference pairs conv inner codes with fec1=none).")


def encode_payload(props, payload: jnp.ndarray) -> jnp.ndarray:
    """payload -> CRC -> fec0 -> fec1 -> scramble (static length)."""
    enc = crc_mod.crc_append(props.check, payload.astype(jnp.uint8))
    enc = fec_mod.fec_encode(props.fec0, enc)
    enc = fec_mod.fec_encode(props.fec1, enc)
    return scramble(enc, salt=2)


def diff_encode_points(increments: jnp.ndarray) -> jnp.ndarray:
    """TX side of DPSK: phase-increment points -> transmitted points.

    Prepends the unit reference point, so the stream is one point longer
    than the increment stream; the receiver's first differential product
    recovers ``increments[0]`` regardless of any static channel phase.
    """
    return jnp.concatenate([
        jnp.ones((1,), increments.dtype), jnp.cumprod(increments)])


def _diff_effective(x: jnp.ndarray, mod: jnp.ndarray):
    """(x_eff, src_offset): differential lag products for DPSK schemes.

    For differential ``mod`` the demap operates on the normalized products
    ``x[k] conj(x[k-1])`` (static phase and slow CFO cancel with no
    equalizer help) and data starts after the reference point; coherent
    schemes pass through untouched.
    """
    is_diff = jnp.asarray(_IS_DIFF)[mod]
    prev = jnp.concatenate([jnp.ones((1,), x.dtype), x[:-1]])
    d = x * jnp.conj(prev)
    d = d / jnp.maximum(jnp.abs(d), 1e-12)
    x_eff = jnp.where(is_diff, d, x)
    return x_eff, is_diff.astype(jnp.int32)


_DEMOD_CHUNK = 16


def _nearest_sym(x: jnp.ndarray, table: jnp.ndarray):
    """``(argmin_c, min_c) |x - table[c]|^2`` via a scan over table chunks.

    Materializing the full ``[n_pts, 256]`` distance matrix is the
    whole-pipeline hot spot for the batched payload decode (the 64-row
    candidate batch reads/writes ~2.4 GB of intermediates; measured
    676 ms on the 4-core host vs 42 ms for this scan — the per-chunk
    ``[n, 16]`` tile stays in cache and ``x`` is reused across chunks).
    First-occurrence tie-breaking matches ``jnp.argmin`` over the full
    axis: strict ``<`` keeps the earliest chunk on ties, and within a
    chunk argmin picks the first.  Padded table entries (1e6+0j) score
    ~1e12 and never win, as before."""
    C = table.shape[0]
    ck = _DEMOD_CHUNK
    xr, xi = jnp.real(x), jnp.imag(x)
    trc = jnp.real(table).reshape(C // ck, ck)
    tic = jnp.imag(table).reshape(C // ck, ck)
    base = (jnp.arange(C // ck) * ck).astype(jnp.int32)

    def body(carry, cs):
        bm, ba = carry
        trk, tik, b0 = cs
        # unrolled elementwise min/argmin update: a broadcast distance
        # tile d[n, ck] here has TWO reduction consumers (min + argmin),
        # so XLA materializes it.  The unrolled running update is one
        # fusion reading x and the carries once per chunk, no tile at
        # all.  Ascending k with strict < keeps jnp.argmin's
        # first-occurrence ties.
        for k in range(ck):
            d = (xr - trk[k]) ** 2 + (xi - tik[k]) ** 2
            upd = d < bm
            bm = jnp.where(upd, d, bm)
            ba = jnp.where(upd, b0 + k, ba)
        return (bm, ba), None

    init = (jnp.full(x.shape, jnp.float32(1e30)),
            jnp.zeros(x.shape, jnp.int32))
    (dmin, sym), _ = jax.lax.scan(body, init, (trc, tic, base))
    return sym, dmin


_BPS_SET = tuple(sorted({modem_mod.bits_per_symbol(s)
                         for s in PAYLOAD_MODS}))


def _bits_from_syms(sym: jnp.ndarray, off: jnp.ndarray, bps: jnp.ndarray,
                    max_bits: int) -> jnp.ndarray:
    """Symbol stream -> MSB-first bit stream ``[max_bits]`` for a traced
    ``bps``, with the DPSK reference-point offset ``off`` (0/1).

    The direct form — ``sym[clip(j // bps + off)]`` — is a traced
    index-array gather under the candidate vmap (the pattern
    ofdm_sync._window_gather avoids).  Instead each STATIC bps in the
    scheme set gets a gather-free layout (broadcast + shift + reshape;
    ``off`` via one dynamic_slice), and a mask-select picks the row's
    layout — layouts are cheap ``[max_bits]`` u8 streams, so computing
    all |{bps}| of them costs far less than one bad gather."""
    n = sym.shape[0]
    streams = []
    for b in _BPS_SET:
        n_sym = -(-max_bits // b) + 1
        pad = max(n_sym + 1 - n, 0)
        sp = jnp.concatenate([sym, jnp.zeros(pad, sym.dtype)]) if pad \
            else sym
        s = jax.lax.dynamic_slice(sp, (jnp.clip(off, 0, 1),), (n_sym,))
        shifts = jnp.arange(b - 1, -1, -1, dtype=sym.dtype)
        bits = ((s[:, None] >> shifts[None, :]) & 1).reshape(-1)
        streams.append(bits[:max_bits].astype(jnp.uint8))
    out = jnp.zeros(max_bits, jnp.uint8)
    for b, bits in zip(_BPS_SET, streams):
        out = jnp.where(bps == b, bits, out)
    return out


def _nearest_point(x: jnp.ndarray, table: jnp.ndarray):
    """``(dec, dmin)``: the nearest constellation POINT (value) per
    sample, via the same chunked scan as :func:`_nearest_sym` but
    carrying the winning point's re/im planes instead of its index.

    Exists for the decision-directed passes: ``tab[_nearest_sym(x)[0]]``
    is a traced index gather under the candidate vmap; the value carry
    costs two extra ``[n]`` planes in the scan and no gather at all."""
    C = table.shape[0]
    ck = _DEMOD_CHUNK
    xr, xi = jnp.real(x), jnp.imag(x)
    trc = jnp.real(table).reshape(C // ck, ck)
    tic = jnp.imag(table).reshape(C // ck, ck)

    def body(carry, cs):
        bm, br, bi = carry
        trk, tik = cs
        for k in range(ck):
            d = (xr - trk[k]) ** 2 + (xi - tik[k]) ** 2
            upd = d < bm
            bm = jnp.where(upd, d, bm)
            br = jnp.where(upd, trk[k], br)
            bi = jnp.where(upd, tik[k], bi)
        return (bm, br, bi), None

    init = (jnp.full(x.shape, jnp.float32(1e30)),
            jnp.zeros(x.shape, jnp.float32),
            jnp.zeros(x.shape, jnp.float32))
    (dmin, br, bi), _ = jax.lax.scan(body, init, (trc, tic))
    return jax.lax.complex(br, bi), dmin


def generic_demod_bits(x: jnp.ndarray, mod: jnp.ndarray, max_bits: int,
                       n_table: int = _MAX_CONST):
    """Demap with a runtime-selected constellation -> bit stream [max_bits].

    ``x``: flat received points [n_pts]; bits laid out bps-per-point
    (MSB-first), where bps is the traced bits/symbol of ``mod``.
    DPSK schemes demap differentially (see :func:`_diff_effective`).
    ``n_table`` statically truncates the padded table scan — exact
    whenever the scheme's constellation fits (entries beyond ``2^bps``
    are 1e6 padding and never win); callers gate it on the batch's max
    bps (see :func:`decode_payload_batch`).
    """
    x, off = _diff_effective(x, mod)
    tabs = jnp.asarray(_stacked_tables())
    table = tabs[mod][:n_table]
    sym, _ = _nearest_sym(x, table)                      # [n_pts]
    bps = jnp.asarray(
        [modem_mod.bits_per_symbol(s) for s in PAYLOAD_MODS],
        dtype=jnp.int32)[mod]
    bits = _bits_from_syms(sym, off, bps, max_bits)
    return bits, bps


def fec_decode_switch(scheme_idx: jnp.ndarray, buf: jnp.ndarray,
                      out_bytes: int, fecs=PAYLOAD_FECS) -> jnp.ndarray:
    """``lax.switch`` over ``fecs``: decode max-size ``buf`` ->
    ``[out_bytes]`` (each branch covers as many bytes as fit statically)."""
    in_bytes = buf.shape[-1]

    def make_branch(s):
        def branch(b):
            n = out_bytes  # largest decodable size whose code fits in buf
            while fec_mod.encoded_length(s, n) > in_bytes and n > 1:
                n -= 1
            need = fec_mod.encoded_length(s, n)
            dec = fec_mod.fec_decode(s, b[:need], n)
            if n < out_bytes:
                dec = jnp.concatenate(
                    [dec, jnp.zeros(out_bytes - n, dtype=jnp.uint8)])
            return dec
        return branch

    return jax.lax.switch(scheme_idx, [make_branch(s) for s in fecs],
                          buf)


def crc_check_dynamic(check: jnp.ndarray, buf: jnp.ndarray,
                      plen: jnp.ndarray) -> jnp.ndarray:
    """Validate CRC over buf[:plen] against buf[plen:plen+w] (traced scheme).

    Branch-free: both CRC16 and CRC32 compute unconditionally and
    ``check`` selects.  A ``lax.switch`` here was a structural trap
    under the callers' vmap (measured 11 ms vs 0.7 ms for a 48-row
    candidate batch on the host: the vmapped switch scalarizes), and
    both CRCs together are two tiny GF(2) matmuls.
    """
    def one(scheme):
        w = crc_mod.crc_width_bytes(scheme)
        got = crc_mod.crc_compute_masked(scheme, buf, plen)
        shifts = jnp.arange(w - 1, -1, -1, dtype=jnp.uint32) * 8
        tail = jax.lax.dynamic_slice(buf, (plen,), (w,))
        want = jnp.sum(tail.astype(jnp.uint32) << shifts,
                       dtype=jnp.uint32)
        return got == want

    ok16 = one(crc_mod.CRC_16)
    ok32 = one(crc_mod.CRC_32)
    return jnp.where(check == 0, jnp.bool_(True),
                     jnp.where(check == 1, ok16, ok32))


@functools.lru_cache(maxsize=None)
def _enc_len_table(fecs: tuple, max_n: int) -> np.ndarray:
    """[len(fecs), max_n+1] encoded-length lookup — makes the per-frame
    encoded size a traced gather (for payload-EVM point counting)."""
    t = np.zeros((len(fecs), max_n + 1), np.int32)
    for i, s in enumerate(fecs):
        for n in range(max_n + 1):
            t[i, n] = fec_mod.encoded_length(s, n)
    return t


def payload_points_used(fecs: tuple, dec_max: int, enc_max: int,
                        plen, mod, f0, f1, check):
    """Traced count of constellation points the payload actually occupies
    (incl. the DPSK reference point)."""
    tab = jnp.asarray(_enc_len_table(fecs, enc_max))
    crc_w = jnp.asarray([0, 2, 4], jnp.int32)[check]
    n1 = jnp.clip(plen + crc_w, 0, dec_max)
    n2 = tab[f0, n1]
    n3 = tab[f1, jnp.clip(n2, 0, enc_max)]
    bps = jnp.asarray(
        [modem_mod.bits_per_symbol(s) for s in PAYLOAD_MODS],
        dtype=jnp.int32)[mod]
    used = (n3 * 8 + bps - 1) // bps
    return used + jnp.asarray(_IS_DIFF)[mod].astype(jnp.int32)


def payload_evm_mse(points: jnp.ndarray, mod, used):
    """Per-row payload MSE vs nearest constellation point: ``points [K,
    n_pts]``, traced scheme ids, ``used [K]`` point counts -> ``[K]``.

    The min distance rides the same chunked scan as the demap
    (:func:`_nearest_sym`) — the naive ``[K, n_pts, 256]`` distance
    matrix this used to build (~800 MB for the 64-candidate batch) was
    the measured top consumer of the whole decode once the demap itself
    was chunked (its old CSE-with-the-demap justification died then).
    """
    x, off = jax.vmap(_diff_effective)(points, mod)
    tabs = jnp.asarray(_stacked_tables())
    dmin = jax.vmap(lambda xr, m: _nearest_sym(xr, tabs[m])[1])(x, mod)
    idx = jnp.arange(points.shape[-1])[None, :]
    mask = (idx >= off[:, None]) & (idx < (used + off)[:, None])
    tot = jnp.sum(jnp.where(mask, dmin, 0.0), axis=-1)
    return tot / jnp.maximum(used.astype(jnp.float32), 1.0)


def frame_evm_db(hevm_db, pay_mse, used, hdr_syms: int = HEADER_SYMS):
    """Combine header EVM (dB) with payload MSE into the frame EVM the
    reference's framesyncstats reports (energy-weighted over symbols).
    ``hdr_syms``: the family's header symbol count (352 for the 14-byte
    flexframe header, 256 default)."""
    hmse = 10.0 ** (hevm_db / 10.0)
    n = hdr_syms + used.astype(jnp.float32)
    tot = (hmse * hdr_syms + pay_mse * used.astype(jnp.float32)) / n
    return 10.0 * jnp.log10(jnp.maximum(tot, 1e-12))


def decode_payload(sync_enc_max: int, dec_max: int, max_payload: int,
                   points: jnp.ndarray, mod, f0, f1, check, plen, hvalid,
                   fecs=PAYLOAD_FECS):
    """Received payload constellation points -> (payload, payload_valid)."""
    pbits, _ = generic_demod_bits(points, mod, sync_enc_max * 8)
    enc_buf = scramble(pack_bits(pbits), salt=2)
    mid = fec_decode_switch(f1, enc_buf, sync_enc_max, fecs)
    dec = fec_decode_switch(f0, mid, dec_max, fecs)
    pvalid = hvalid & crc_check_dynamic(check, dec, plen)
    payload = jnp.where(jnp.arange(max_payload) < plen,
                        dec[:max_payload], 0).astype(jnp.uint8)
    return payload, pvalid


def _fec_batch(scheme_ids: jnp.ndarray, bufs: jnp.ndarray, out_bytes: int,
               fecs) -> jnp.ndarray:
    """Batched FEC decode: ``bufs [K, in]`` with per-row scheme ids.

    Under ``vmap`` a ``lax.switch`` executes every branch per element (K x
    redundant work); here each scheme decodes the *whole batch once* and a
    masked select picks the right row — the branch set runs once total.
    """
    in_bytes = bufs.shape[-1]
    out = jnp.zeros((bufs.shape[0], out_bytes), dtype=jnp.uint8)
    for idx, s in enumerate(fecs):
        n = out_bytes
        while fec_mod.encoded_length(s, n) > in_bytes and n > 1:
            n -= 1
        need = fec_mod.encoded_length(s, n)
        if fec_mod._is_conv(s) or s == fec_mod.FEC_RS8:
            dec = jax.vmap(lambda b: fec_mod.fec_decode(s, b, n))(
                bufs[:, :need])
        else:
            dec = fec_mod.fec_decode(s, bufs[:, :need], n)
        if n < out_bytes:
            dec = jnp.concatenate(
                [dec, jnp.zeros((bufs.shape[0], out_bytes - n),
                                dtype=jnp.uint8)], axis=-1)
        out = jnp.where((scheme_ids == idx)[:, None], dec, out)
    return out


def decode_payload_batch(sync_enc_max: int, dec_max: int, max_payload: int,
                         points: jnp.ndarray, mod, f0, f1, check, plen,
                         hvalid, fecs=PAYLOAD_FECS):
    """Batched payload decode for K candidates: ``points [K, n_pts]``,
    per-row props -> (payload [K, max_payload], payload_valid [K])."""
    # batch-gated table size: when no candidate uses a >64-point scheme
    # (the common case — QPSK-class traffic), scan only the first 64
    # table entries (4 chunks instead of 16; entries past 2^bps are
    # padding and never win).  ONE scalar lax.cond outside the vmap —
    # never a per-row switch (the crc_check_dynamic lesson).
    bps_all = jnp.asarray(
        [modem_mod.bits_per_symbol(s) for s in PAYLOAD_MODS],
        dtype=jnp.int32)[mod]
    small = jnp.all(bps_all <= 6)

    def demod(n_tab):
        def fn(pm):
            pts, m = pm
            return jax.vmap(
                lambda x, mm: generic_demod_bits(
                    x, mm, sync_enc_max * 8, n_table=n_tab)[0])(pts, m)
        return fn

    pbits = jax.lax.cond(small, demod(64), demod(_MAX_CONST),
                         (points, mod))
    enc = scramble(jax.vmap(pack_bits)(pbits), salt=2)
    mid = _fec_batch(f1, enc, sync_enc_max, fecs)
    dec = _fec_batch(f0, mid, dec_max, fecs)
    crc_ok = jax.vmap(crc_check_dynamic)(check, dec, plen)
    pvalid = hvalid & crc_ok
    payload = jnp.where(jnp.arange(max_payload)[None, :] < plen[:, None],
                        dec[:, :max_payload], 0).astype(jnp.uint8)
    return payload, pvalid


# ---------------------------------------------------------------------------
# soft-decision path (conv codes gain ~2 dB from soft Viterbi)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bit_masks() -> np.ndarray:
    """[n_schemes, 256, 8] bit of each constellation index, MSB-first per
    scheme (slot k = bit (bps-1-k)); zero beyond bps."""
    out = np.zeros((len(PAYLOAD_MODS), _MAX_CONST, 8), dtype=np.float32)
    for s in PAYLOAD_MODS:
        bps = modem_mod.bits_per_symbol(s)
        M = 1 << bps
        for c in range(M):
            for k in range(bps):
                out[s, c, k] = (c >> (bps - 1 - k)) & 1
    return out


def generic_demod_soft(x: jnp.ndarray, mod: jnp.ndarray, max_bits: int,
                       n_table: int = _MAX_CONST):
    """Max-log per-bit LLRs for a runtime-selected constellation.

    Returns ``llr [max_bits]`` float32 laid out exactly like
    :func:`generic_demod_bits` (positive => bit 1).  Dummy padding points
    sit at distance ~1e12 and never win a min.  ``n_table`` statically
    truncates the padded table scan (exact whenever the scheme fits;
    see :func:`generic_demod_bits`).
    """
    x, off = _diff_effective(x, mod)
    tabs = jnp.asarray(_stacked_tables())
    table = tabs[mod][:n_table]
    bm = jnp.asarray(_bit_masks())[mod][:n_table]        # [n_table, 8]
    # per-bit min distances via the same chunked scan as _nearest_sym:
    # the naive [n_pts, 8, 256] masked-min materialized ~8x the hard
    # path's already-hot distance matrix (measured 54 s for the 64-row
    # candidate batch on the host; ~0.4 s chunked)
    C = table.shape[0]
    ck = _DEMOD_CHUNK
    xr, xi = jnp.real(x), jnp.imag(x)
    trc = jnp.real(table).reshape(C // ck, ck)
    tic = jnp.imag(table).reshape(C // ck, ck)
    bmc = bm.reshape(C // ck, ck, 8)
    INF = jnp.float32(1e12)

    def body(carry, cs):
        d0s, d1s = carry
        trk, tik, bmk = cs
        # unrolled elementwise updates (same rationale as _nearest_sym:
        # a [n, ck] distance tile with 16 reduction consumers
        # materializes).  Carries are 8+8 separate [n] planes.
        d0s, d1s = list(d0s), list(d1s)
        for k in range(ck):
            d = (xr - trk[k]) ** 2 + (xi - tik[k]) ** 2  # [n]
            for kbit in range(8):
                is1 = bmk[k, kbit] == 1                  # traced scalar
                d0s[kbit] = jnp.minimum(d0s[kbit],
                                        jnp.where(is1, INF, d))
                d1s[kbit] = jnp.minimum(d1s[kbit],
                                        jnp.where(is1, d, INF))
        return (tuple(d0s), tuple(d1s)), None

    init_p = (tuple(jnp.full(x.shape, INF) for _ in range(8)),
              tuple(jnp.full(x.shape, INF) for _ in range(8)))
    (d0s, d1s), _ = jax.lax.scan(body, init_p, (trc, tic, bmc))
    llr_pts = jnp.stack(d0s, axis=-1) - jnp.stack(d1s, axis=-1)
    bps = jnp.asarray(
        [modem_mod.bits_per_symbol(s) for s in PAYLOAD_MODS],
        dtype=jnp.int32)[mod]
    # per-static-bps gather-free layouts + mask-select — the direct
    # ``llr_pts[j // bps + off, j % bps]`` traced 2-D gather lowers
    # catastrophically under the candidate vmap (see _bits_from_syms)
    n = llr_pts.shape[0]
    out = jnp.zeros(max_bits, llr_pts.dtype)
    for b in _BPS_SET:
        n_sym = -(-max_bits // b) + 1
        pad = max(n_sym + 1 - n, 0)
        lp = jnp.concatenate(
            [llr_pts, jnp.zeros((pad, llr_pts.shape[1]),
                                llr_pts.dtype)]) if pad else llr_pts
        s = jax.lax.dynamic_slice(
            lp, (jnp.clip(off, 0, 1), 0), (n_sym, lp.shape[1]))
        stream = s[:, :b].reshape(-1)[:max_bits]
        out = jnp.where(bps == b, stream, out)
    return out


def decode_payload_batch_soft(sync_enc_max: int, dec_max: int,
                              max_payload: int, points: jnp.ndarray,
                              mod, f0, f1, check, plen, hvalid,
                              fecs=PAYLOAD_FECS):
    """Batched payload decode with soft LLRs for conv FEC branches.

    Hard path for block codes (identical to decode_payload_batch); conv
    branches run soft Viterbi on descrambled LLRs (sign-flipped where the
    scramble PN bit is 1).
    """
    from ..ops import conv as conv_mod
    K = points.shape[0]
    # batch-gated table size, as in decode_payload_batch (one scalar
    # cond outside the vmap; 4-chunk scan for QPSK-class batches)
    bps_all = jnp.asarray(
        [modem_mod.bits_per_symbol(s) for s in PAYLOAD_MODS],
        dtype=jnp.int32)[mod]
    small = jnp.all(bps_all <= 6)

    def dsoft(n_tab):
        def fn(pm):
            pts, m = pm
            return jax.vmap(
                lambda x, mm: generic_demod_soft(
                    x, mm, sync_enc_max * 8, n_table=n_tab))(pts, m)
        return fn

    llrs = jax.lax.cond(small, dsoft(64), dsoft(_MAX_CONST),
                        (points, mod))
    hard = (llrs > 0).astype(jnp.uint8)
    enc = scramble(jax.vmap(pack_bits)(hard), salt=2)
    pn_bits = jnp.asarray(np.unpackbits(
        _scramble_np(sync_enc_max, 2))).astype(jnp.float32)
    llr_desc = llrs * (1.0 - 2.0 * pn_bits)[None, :]

    def fec_stage(scheme_ids, bufs, bufs_llr, out_bytes, llr_ok=None):
        """``llr_ok`` (bool [K], optional): rows whose ``bufs_llr`` is a
        valid channel-LLR view of ``bufs`` — conv branches decode those
        rows soft and the rest hard."""
        in_bytes = bufs.shape[-1]
        out = jnp.zeros((K, out_bytes), jnp.uint8)
        for idx, s in enumerate(fecs):
            n = out_bytes
            while fec_mod.encoded_length(s, n) > in_bytes and n > 1:
                n -= 1
            need = fec_mod.encoded_length(s, n)
            if fec_mod._is_conv(s) and bufs_llr is not None:
                L = bufs_llr[:, :need * 8]
                if llr_ok is not None:
                    # rows without valid channel LLRs decode from their
                    # hard bytes as +-1 pseudo-LLRs — constant magnitude
                    # makes soft Viterbi metric-equivalent to hard, so
                    # ONE soft pass covers both row classes (running a
                    # separate full-batch hard Viterbi would double the
                    # most expensive decode stage)
                    bits = jax.vmap(unpack_bits)(
                        bufs[:, :need]).astype(jnp.float32)
                    L = jnp.where(llr_ok[:, None], L, 2.0 * bits - 1.0)
                dec = jax.vmap(
                    lambda Lr: conv_mod.conv_decode_soft(s, Lr, n))(L)
            elif fec_mod._is_conv(s) or s == fec_mod.FEC_RS8:
                dec = jax.vmap(lambda b: fec_mod.fec_decode(s, b, n))(
                    bufs[:, :need])
            else:
                dec = fec_mod.fec_decode(s, bufs[:, :need], n)
            if n < out_bytes:
                dec = jnp.concatenate(
                    [dec, jnp.zeros((K, out_bytes - n), jnp.uint8)],
                    axis=-1)
            out = jnp.where((scheme_ids == idx)[:, None], dec, out)
        return out

    # outer (fec1) sees channel LLRs.  The inner (fec0) normally decodes
    # fec1's hard output (LLRs are no longer meaningful after a real
    # outer decode) — EXCEPT when fec1 is none: then the outer stage is
    # the identity and the channel LLRs are still a valid view of the
    # inner code's input, which is exactly the canonical conv config
    # (fec0=v27/v29, fec1=none — the reference pairs them this way too)
    mid = fec_stage(f1, enc, llr_desc, sync_enc_max)
    dec = fec_stage(f0, mid, llr_desc, dec_max,
                    llr_ok=(f1 == fec_mod.FEC_NONE))
    crc_ok = jax.vmap(crc_check_dynamic)(check, dec, plen)
    pvalid = hvalid & crc_ok
    payload = jnp.where(jnp.arange(max_payload)[None, :] < plen[:, None],
                        dec[:, :max_payload], 0).astype(jnp.uint8)
    return payload, pvalid
