"""802.11a wire-compliance goldens from the published standard text.

The other wlan tests pit the vectorized coder against a
serial reference written in the same repo — both ends could share one
convention misread (round 2's LSB-first conv-generator bug proved the
risk).  This file pins the TX chain against text the repo did NOT write:

* the 127-bit scrambler sequence printed in IEEE 802.11a-1999 §17.3.5.4
  (Figure 111's "all ones initial state" example output),
* Annex G Table G.2 (time-domain short training sequence) and Table G.6
  (time-domain long training symbol) literal sample values,
* the Annex G worked example's SIGNAL field (36 Mb/s, LENGTH=100) bit
  layout,
* the normative constellation mapping tables (17-8/17-9/17-10) and pilot
  polarity sequence p_n (§17.3.5.9) as literals,

plus a fully independent bit-level reference transmitter (sequential LFSR
/ shift-register / per-bit interleaver loops written directly from the
normative clause equations — no shared code or style with
``framing/wlan.py``'s vectorized GF(2) formulation) compared sample-exact
over multiple rates.

Reference capability anchor: /root/reference/src/wlanframe_tx.cc:174-231
(liquid-wlan TX, 8 rates).
"""
import numpy as np
import pytest

from liquid_usrp_tpu.framing import wlan

# module power normalization: the standard's Annex G tables list plain
# 1/64-scaled IFFT outputs; framing/wlan.py additionally normalizes to
# unit average power with 64/sqrt(52)
_SCALE = 64.0 / np.sqrt(52.0)


# --- §17.3.5.4 Figure 111: scrambler output, all-ones initial state ------
_SCRAMBLER_127 = (
    "00001110 11110010 11001001 00000010 00100110 00101110 10110110 "
    "00001100 11010100 11100111 10110100 00101010 11111010 01010001 "
    "10111000 1111111").replace(" ", "")


def test_scrambler_sequence_matches_standard_figure():
    seq = wlan._scramble_seq(0x7F)
    want = np.array([int(c) for c in _SCRAMBLER_127], np.uint8)
    assert len(want) == 127
    np.testing.assert_array_equal(seq, want)


# --- §17.3.5.9: pilot polarity sequence p_0..p_15 (literal from text) ----
_PILOT_POLARITY_16 = [1, 1, 1, 1, -1, -1, -1, 1, -1, -1, -1, -1, 1, 1, -1, 1]


def test_pilot_polarity_first_16():
    _, _, pn = wlan._tables()
    np.testing.assert_array_equal(pn[:16], _PILOT_POLARITY_16)


# --- Annex G Table G.2: short training sequence, one 16-sample period ----
# (3-decimal values exactly as printed in the standard)
_ANNEXG_SHORT_16 = np.array([
    0.046 + 0.046j, -0.132 + 0.002j, -0.013 - 0.079j, 0.143 - 0.013j,
    0.092 + 0.000j, 0.143 - 0.013j, -0.013 - 0.079j, -0.132 + 0.002j,
    0.046 + 0.046j, 0.002 - 0.132j, -0.079 - 0.013j, -0.013 + 0.143j,
    0.000 + 0.092j, -0.013 + 0.143j, -0.079 - 0.013j, 0.002 - 0.132j,
])


def test_short_training_matches_annexg_table():
    short, _, _ = wlan._tables()
    np.testing.assert_allclose(short[:16] / _SCALE, _ANNEXG_SHORT_16,
                               atol=7.5e-4)
    # and the assembled frame transmits exactly 10 of these periods
    frame = np.asarray(wlan.wlan_assemble(6, np.zeros(10, np.uint8)))
    got = frame[:160].reshape(10, 16) / _SCALE
    np.testing.assert_allclose(got, np.tile(_ANNEXG_SHORT_16, (10, 1)),
                               atol=7.5e-4)


# --- Annex G Table G.6: long training symbol, first 8 samples ------------
_ANNEXG_LONG_8 = np.array([
    0.156 + 0.000j, -0.005 - 0.120j, 0.040 - 0.111j, 0.097 + 0.083j,
    0.021 + 0.028j, 0.060 - 0.088j, -0.115 - 0.055j, -0.038 - 0.106j,
])


def test_long_training_matches_annexg_table():
    _, long_t, _ = wlan._tables()
    np.testing.assert_allclose(long_t[:8] / _SCALE, _ANNEXG_LONG_8,
                               atol=7.5e-4)
    # frame layout: 32-sample GI2 (last 32 of the symbol) then 2x the
    # 64-sample symbol, starting at sample 160
    frame = np.asarray(wlan.wlan_assemble(6, np.zeros(10, np.uint8)))
    np.testing.assert_allclose(frame[192:200] / _SCALE, _ANNEXG_LONG_8,
                               atol=7.5e-4)
    np.testing.assert_allclose(frame[256:264] / _SCALE, _ANNEXG_LONG_8,
                               atol=7.5e-4)


# --- Annex G worked example: SIGNAL field for 36 Mb/s, LENGTH=100 --------
# RATE=1011, reserved 0, LENGTH=100 LSB-first, even parity, 6 tail zeros
_ANNEXG_SIGNAL_24 = [1, 0, 1, 1,
                     0,
                     0, 0, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0,
                     0,
                     0, 0, 0, 0, 0, 0]


def _signal_bits_from_frame(frame):
    """Demap + decode the (noise-free) SIGNAL symbol back to its 24 bits
    using only numpy written here: hard BPSK -> deinterleave via the
    normative equations -> invert the rate-1/2 coder by re-encoding all
    prefixes is overkill for a clean symbol; instead decode with the
    textbook observation that coded bit pairs of a K=7 code are linear in
    the data — we just re-encode candidate bits sequentially."""
    sig_t = frame[320 + 16:320 + 80]
    grid = np.fft.fft(sig_t) / _SCALE
    didx = [k % 64 for k in range(-26, 27)
            if k != 0 and abs(k) != 7 and abs(k) != 21]
    inter = (np.real(grid[didx]) > 0).astype(np.uint8)
    # deinterleave (NCBPS=48, NBPSC=1): normative 17.3.5.6 inverse
    coded = np.empty(48, np.uint8)
    for k in range(48):
        i = 3 * (k % 16) + k // 16      # first permutation (N/16 = 3)
        coded[k] = inter[i]             # s = 1: second perm is identity
    # sequential shift-register decode of the clean rate-1/2 stream:
    # A_i = b_i ^ b_{i-2} ^ b_{i-3} ^ b_{i-5} ^ b_{i-6}  (g0 = 133)
    reg = [0] * 6
    bits = np.empty(24, np.uint8)
    for i in range(24):
        a = coded[2 * i]
        b_i = a ^ reg[1] ^ reg[2] ^ reg[4] ^ reg[5]
        # confirm against the g1=171 output: B = b^b-1^b-2^b-3^b-6
        assert coded[2 * i + 1] == (b_i ^ reg[0] ^ reg[1] ^
                                    reg[2] ^ reg[5])
        bits[i] = b_i
        reg = [b_i] + reg[:5]
    return bits


def test_annexg_signal_field_bits():
    frame = np.asarray(wlan.wlan_assemble(36, np.zeros(100, np.uint8)))
    got = _signal_bits_from_frame(frame)
    np.testing.assert_array_equal(got, _ANNEXG_SIGNAL_24)


# --- normative constellation tables 17-8 / 17-9 / 17-10 as literals ------
def test_constellation_tables():
    s2, s10, s42 = np.sqrt(2), np.sqrt(10), np.sqrt(42)
    # BPSK (Table 17-7): 0 -> -1, 1 -> +1
    np.testing.assert_allclose(
        wlan._map_bits(np.array([0, 1], np.uint8), 1), [-1, 1])
    # QPSK (Table 17-8): b0 -> I, b1 -> Q, 0 -> -1, 1 -> +1
    np.testing.assert_allclose(
        wlan._map_bits(np.array([0, 0, 1, 0, 0, 1, 1, 1], np.uint8), 2),
        np.array([-1 - 1j, 1 - 1j, -1 + 1j, 1 + 1j]) / s2, atol=1e-7)
    # 16-QAM (Table 17-9): b0b1 -> I in {00:-3, 01:-1, 11:+1, 10:+3}
    for b0b1, amp in [((0, 0), -3), ((0, 1), -1), ((1, 1), 1), ((1, 0), 3)]:
        pt = wlan._map_bits(np.array(list(b0b1) + [0, 0], np.uint8), 4)[0]
        assert abs(pt.real - amp / s10) < 1e-7
        pt = wlan._map_bits(np.array([0, 0] + list(b0b1), np.uint8), 4)[0]
        assert abs(pt.imag - amp / s10) < 1e-7
    # 64-QAM (Table 17-10): b0b1b2 -> I in {000:-7, 001:-5, 011:-3,
    # 010:-1, 110:+1, 111:+3, 101:+5, 100:+7}
    t = [((0, 0, 0), -7), ((0, 0, 1), -5), ((0, 1, 1), -3), ((0, 1, 0), -1),
         ((1, 1, 0), 1), ((1, 1, 1), 3), ((1, 0, 1), 5), ((1, 0, 0), 7)]
    for bbb, amp in t:
        pt = wlan._map_bits(np.array(list(bbb) + [0, 0, 0], np.uint8), 6)[0]
        assert abs(pt.real - amp / s42) < 1e-7
        pt = wlan._map_bits(np.array([0, 0, 0] + list(bbb), np.uint8), 6)[0]
        assert abs(pt.imag - amp / s42) < 1e-7


# --- independent bit-level reference transmitter --------------------------
def _ref_tx(rate, psdu, seed=0x5D):
    """Sequential 802.11a TX written directly from the clause equations
    (LFSR loop, shift-register encoder, per-bit interleaver, literal
    constellations) — deliberately nothing in common with the vectorized
    module implementation."""
    bpsc, (num, den), ncbps, ndbps = {
        6: (1, (1, 2), 48, 24), 9: (1, (3, 4), 48, 36),
        12: (2, (1, 2), 96, 48), 18: (2, (3, 4), 96, 72),
        24: (4, (1, 2), 192, 96), 36: (4, (3, 4), 192, 144),
        48: (6, (2, 3), 288, 192), 54: (6, (3, 4), 288, 216)}[rate]
    length = len(psdu)

    # ---- DATA bits: SERVICE + PSDU (LSB first per octet) + tail + pad
    n_sym = int(np.ceil((16 + 8 * length + 6) / ndbps))
    bits = [0] * 16
    for byte in psdu:
        for i in range(8):
            bits.append((int(byte) >> i) & 1)
    bits += [0] * (n_sym * ndbps - len(bits))

    # ---- scramble with the LFSR itself (17.3.5.4), then zero the tail
    state = seed & 0x7F
    scrambled = []
    for b in bits:
        s = ((state >> 6) ^ (state >> 3)) & 1
        state = ((state << 1) | s) & 0x7F
        scrambled.append(b ^ s)
    for i in range(16 + 8 * length, 16 + 8 * length + 6):
        scrambled[i] = 0

    # ---- rate-1/2 mother code, shift-register form (17.3.5.5)
    def encode(data_bits):
        reg = [0] * 6
        out = []
        for b in data_bits:
            out.append(b ^ reg[1] ^ reg[2] ^ reg[4] ^ reg[5])   # g0 = 133
            out.append(b ^ reg[0] ^ reg[1] ^ reg[2] ^ reg[5])   # g1 = 171
            reg = [b] + reg[:5]
        return out

    coded = encode(scrambled)
    # ---- puncture (Figure 17-9): 2/3 steals B1 of [A0B0A1B1];
    # 3/4 steals B1,A2 of [A0B0A1B1A2B2]
    if (num, den) == (2, 3):
        coded = [c for i, c in enumerate(coded) if i % 4 != 3]
    elif (num, den) == (3, 4):
        coded = [c for i, c in enumerate(coded) if i % 6 not in (3, 4)]

    # ---- per-symbol interleave (17.3.5.6, both equations verbatim)
    s = max(bpsc // 2, 1)
    inter = []
    for sym in range(n_sym):
        blk = coded[sym * ncbps:(sym + 1) * ncbps]
        out = [0] * ncbps
        for k in range(ncbps):
            i = (ncbps // 16) * (k % 16) + k // 16
            j = s * (i // s) + (i + ncbps - (16 * i) // ncbps) % s
            out[j] = blk[k]
        inter.extend(out)

    # ---- map to constellation points (literal normative tables)
    def pam(bseq, table):
        idx = 0
        for b in bseq:
            idx = (idx << 1) | b
        return table[idx]

    pts = []
    for n0 in range(0, len(inter), bpsc):
        g = inter[n0:n0 + bpsc]
        if bpsc == 1:
            pts.append(complex(2 * g[0] - 1, 0))
        elif bpsc == 2:
            pts.append(complex(2 * g[0] - 1, 2 * g[1] - 1) / np.sqrt(2))
        elif bpsc == 4:
            t = {0b00: -3, 0b01: -1, 0b11: 1, 0b10: 3}
            pts.append(complex(pam(g[:2], t), pam(g[2:], t)) / np.sqrt(10))
        else:
            t = {0b000: -7, 0b001: -5, 0b011: -3, 0b010: -1,
                 0b110: 1, 0b111: 3, 0b101: 5, 0b100: 7}
            pts.append(complex(pam(g[:3], t), pam(g[3:], t)) / np.sqrt(42))

    # ---- SIGNAL field (17.3.4)
    rate_bits = {6: [1, 1, 0, 1], 9: [1, 1, 1, 1], 12: [0, 1, 0, 1],
                 18: [0, 1, 1, 1], 24: [1, 0, 0, 1], 36: [1, 0, 1, 1],
                 48: [0, 0, 0, 1], 54: [0, 0, 1, 1]}[rate]
    sig = rate_bits + [0] + [(length >> i) & 1 for i in range(12)]
    sig = sig + [sum(sig) % 2] + [0] * 6
    sig_coded = encode(sig)
    sig_inter = [0] * 48
    for k in range(48):
        i = 3 * (k % 16) + k // 16
        sig_inter[i] = sig_coded[k]
    sig_pts = [complex(2 * b - 1, 0) for b in sig_inter]

    # ---- pilot polarity = scrambler sequence of seed 0x7F as +-1
    st = 0x7F
    pn = []
    for _ in range(127):
        s_ = ((st >> 6) ^ (st >> 3)) & 1
        st = ((st << 1) | s_) & 0x7F
        pn.append(1 - 2 * s_)

    # ---- OFDM assembly: 48 data carriers, pilots at +-7, +-21
    data_k = [k for k in range(-26, 27)
              if k != 0 and abs(k) != 7 and abs(k) != 21]
    time = []
    all_pts = [sig_pts] + [pts[i * 48:(i + 1) * 48] for i in range(n_sym)]
    for sym_i, spts in enumerate(all_pts):
        grid = np.zeros(64, complex)
        for c, k in zip(spts, data_k):
            grid[k % 64] = c
        for k, pol in zip([-21, -7, 7, 21], [1, 1, 1, -1]):
            grid[k % 64] = pol * pn[sym_i % 127]
        td = np.fft.ifft(grid) * _SCALE
        time.extend(td[-16:])
        time.extend(td)

    # ---- preambles
    short = np.fft.ifft(_short_freq()) * _SCALE
    long_t = np.fft.ifft(_long_freq()) * _SCALE
    pre = list(np.tile(short[:16], 10)) + list(long_t[-32:]) + \
        list(long_t) + list(long_t)
    return np.array(pre + time, np.complex64)


def _short_freq():
    S = np.zeros(64, complex)
    for k, v in {-24: 1 + 1j, -20: -1 - 1j, -16: 1 + 1j, -12: -1 - 1j,
                 -8: -1 - 1j, -4: 1 + 1j, 4: -1 - 1j, 8: -1 - 1j,
                 12: 1 + 1j, 16: 1 + 1j, 20: 1 + 1j, 24: 1 + 1j}.items():
        S[k % 64] = np.sqrt(13.0 / 6.0) * v
    return S


def _long_freq():
    L_seq = [1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1, 1, 1, -1, -1, 1, 1,
             -1, 1, -1, 1, 1, 1, 1, 0, 1, -1, -1, 1, 1, -1, 1, -1, 1, -1,
             -1, -1, -1, -1, 1, 1, -1, -1, 1, -1, 1, -1, 1, 1, 1, 1]
    L = np.zeros(64, complex)
    for i, k in enumerate(range(-26, 27)):
        L[k % 64] = L_seq[i]
    return L


@pytest.mark.parametrize("rate,n", [(6, 37), (24, 64), (36, 100), (54, 91)])
def test_assemble_matches_independent_reference(rate, n):
    rng = np.random.default_rng(rate)
    psdu = rng.integers(0, 256, n, dtype=np.uint8)
    got = np.asarray(wlan.wlan_assemble(rate, psdu))
    want = _ref_tx(rate, psdu)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_decode_of_independent_reference_frame():
    """Cross-decode: the module RX recovers the PSDU from a frame built
    by the independent reference TX (not by the module's own TX)."""
    rng = np.random.default_rng(99)
    psdu = rng.integers(0, 256, 100, dtype=np.uint8)
    frame = _ref_tx(36, psdu)
    d = wlan.wlan_decode(frame)
    assert d["signal_valid"] and d["rate"] == 36 and d["length"] == 100
    assert d["psdu_valid"]
    np.testing.assert_array_equal(d["psdu"], psdu)
