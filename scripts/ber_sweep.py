"""BER/PER-vs-SNR sweep harness.

The quantitative version of the reference's loopback-pair validation
(SURVEY.md §4): TX chain -> AWGN/CFO channel -> RX chain at each SNR,
reporting frame-detection rate, header error rate, packet error rate and
residual payload BER.  Usable for any of the three frame families.

Usage:
  python scripts/ber_sweep.py [ofdm|flex|gmsk] [--snrs 0,2,...,20]
          [--frames 20] [--payload 200] [--json out.json]
          [--fec0 v27] [--fec1 none] [--soft]

``--fec0/--fec1`` override the family-default payload FEC pair (liquid
names); ``--soft`` routes channel LLRs into the conv Viterbi branches
(soft-vs-hard gain is ~1.5-2 dB on rate-1/2 codes).
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

if os.environ.get("JAX_PLATFORMS") == "cpu":
    # honor an explicit cpu request in the live config too
    import jax
    jax.config.update("jax_platforms", "cpu")


def run_sweep(family: str, snrs, n_frames: int, payload_len: int,
              cfo: float = 0.001, seed: int = 0, fec0: str = None,
              fec1: str = None, soft: bool = False):
    import jax
    import jax.numpy as jnp
    from liquid_usrp_tpu.framing import payload as payload_codec
    from liquid_usrp_tpu.io import channel_model as chan
    from liquid_usrp_tpu.ops import fec as fec_mod

    def with_fec0(props):
        if fec0 is not None:
            props = props._replace(fec0=fec_mod.fec_from_name(fec0))
        if fec1 is not None:
            props = props._replace(fec1=fec_mod.fec_from_name(fec1))
        return props

    def sync_opts(props):
        """enable_conv when either scheme needs the extended decode set
        (conv/RS); expansion auto-sized to fit the pair at this payload."""
        return dict(
            enable_conv=any(s not in payload_codec.PAYLOAD_FECS
                            for s in (props.fec0, props.fec1)),
            soft=soft,
            expansion=payload_codec.required_expansion(props, payload_len))

    if family == "ofdm":
        from liquid_usrp_tpu.framing import ofdm, ofdm_sync
        params = ofdm.make_ofdm_params(48, 6, 4)
        props = with_fec0(ofdm.default_props())
        opts = sync_opts(props)
        sync = ofdm_sync.make_sync(params, block_size=8192,
                                   max_payload=max(payload_len, 64),
                                   max_frames=4, **opts)
        step = ofdm_sync.make_sync_step(sync)
        init = lambda: ofdm_sync.sync_init(sync)
        assemble = lambda h, p: ofdm.assemble_frame(
            params, props, jnp.asarray(h), jnp.asarray(p),
            expansion=opts["expansion"])
    elif family == "flex":
        from liquid_usrp_tpu.framing import flexframe as ff
        from liquid_usrp_tpu.framing import flexframe_sync as ffs
        params = ff.make_flex_params()
        props = with_fec0(ff.default_props())
        opts = sync_opts(props)
        sync = ffs.make_flex_sync(params, block_size=8192,
                                  max_payload=max(payload_len, 64),
                                  max_frames=4, **opts)
        step = ffs.make_flex_sync_step(sync)
        init = lambda: ffs.flex_sync_init(sync)
        assemble = lambda h, p: ff.flex_assemble(
            params, props, jnp.asarray(h), jnp.asarray(p),
            expansion=opts["expansion"])
    elif family == "gmsk":
        from liquid_usrp_tpu.framing import gmskframe as gf
        params = gf.make_gmsk_params()
        props = with_fec0(gf.gmsk_default_props())
        opts = sync_opts(props)
        sync = gf.make_gmsk_sync(params, block_size=8192,
                                 max_payload=max(payload_len, 64),
                                 max_frames=4, **opts)
        step = gf.make_gmsk_sync_step(sync)
        init = lambda: gf.gmsk_sync_init(sync)
        assemble = lambda h, p: gf.gmsk_assemble(
            params, props, jnp.asarray(h), jnp.asarray(p),
            expansion=opts["expansion"])
    else:
        raise ValueError(family)

    if soft and fec_mod._is_conv(props.fec0) \
            and props.fec1 != fec_mod.FEC_NONE:
        # channel LLRs are only a valid view of the inner code's input
        # when the outer stage is the identity (payload.py fec_stage
        # llr_ok); measured PER will be hard-identical in this config —
        # the silent trap that produced the first round-3 v27 artifacts
        print("warning: --soft with a conv fec0 needs --fec1 none to "
              "engage soft Viterbi (outer decode invalidates channel "
              "LLRs); this sweep will decode hard-equivalently",
              file=sys.stderr)

    rng = np.random.default_rng(seed)
    payloads = [rng.integers(0, 256, payload_len, dtype=np.uint8)
                for _ in range(n_frames)]
    headers = [rng.integers(0, 256, getattr(sync, "header_user", 8),
                            dtype=np.uint8)
               for _ in range(n_frames)]
    frames = [np.asarray(assemble(h, p))
              for h, p in zip(headers, payloads)]
    gap = 600
    stream = np.zeros(sum(len(f) + gap for f in frames) + gap,
                      np.complex64)
    positions = []
    pos = gap
    for f in frames:
        stream[pos:pos + len(f)] = f
        positions.append(pos)
        pos += len(f) + gap
    # SNR is defined on the occupied (frame) samples, not the whole stream
    # incl. idle gaps — required for an honest theory-curve comparison
    sig_pwr = float(np.mean(np.concatenate(
        [np.abs(f) ** 2 for f in frames])))

    bs = sync.block_size
    flush = int(np.ceil(sync.overlap / bs)) + 1
    total = (-(-len(stream) // bs) + flush) * bs

    results = []
    for snr in snrs:
        ch = chan.Channel(snr_db=float(snr), cfo=cfo)
        noisy = np.asarray(chan.channel_apply(
            ch, jax.random.PRNGKey(int(snr * 10) + 1),
            jnp.asarray(stream), signal_power=sig_pwr))
        noisy = np.concatenate(
            [noisy, np.zeros(total - len(noisy), np.complex64)])
        state = init()
        det, hok, pok, bit_errs, bits_tot = 0, 0, 0, 0, 0
        got = {}
        for b in range(total // bs):
            state, res = step(state, jnp.asarray(noisy[b * bs:(b + 1) * bs]))
            d = np.asarray(res.detected)
            for i in np.nonzero(d)[0]:
                det += 1
                if bool(res.header_valid[i]):
                    hok += 1
                t = int(res.t_start[i])
                # match to the nearest transmitted frame for BER/PER
                j = int(np.argmin([abs(t - p) for p in positions]))
                if abs(t - positions[j]) < 50 and j not in got:
                    # dedup: a duplicate detection of an already-matched
                    # frame must not double-count packets or bits (a
                    # double-counted pok made PER go negative)
                    got[j] = True
                    if bool(res.payload_valid[i]):
                        pok += 1
                    dec = np.asarray(res.payload[i])[:payload_len]
                    if len(dec) == payload_len:
                        bit_errs += int(np.unpackbits(
                            dec ^ payloads[j]).sum())
                        bits_tot += payload_len * 8
        results.append({
            "snr_db": float(snr),
            "frames_sent": n_frames,
            "frames_detected": det,
            "header_errors": det - hok,
            "packet_error_rate": 1.0 - pok / n_frames,
            "payload_ber": (bit_errs / bits_tot) if bits_tot else 1.0,
        })
        print("snr %5.1f dB: det %3d/%3d  hdr_ok %3d  PER %.3f  BER %.2e" %
              (snr, det, n_frames, hok,
               results[-1]["packet_error_rate"], results[-1]["payload_ber"]))
    return results


def _qfunc(x):
    from scipy.special import erfc
    return 0.5 * erfc(np.asarray(x) / np.sqrt(2.0))


def _block_code_ok(p, n, t):
    """P(codeword decodes) for an (n, .) code correcting t errors, raw
    bit-error prob p."""
    from scipy.special import comb
    return float(sum(comb(n, i) * p ** i * (1 - p) ** (n - i)
                     for i in range(t + 1)))


def theory_per(family: str, snr_db: float, payload_len: int) -> float:
    """Analytic coded PER for the sweep's default configs — the oracle the
    measured waterfall is compared against (implementation loss = measured
    SNR at a PER level minus this curve's SNR at the same level).

    Raw BER uses the coherent matched-filter bound for the payload
    modulation; FEC/CRC structure matches the family defaults (gmsk: CRC16
    + Hamming(7,4); ofdm/flex: CRC32 + Hamming(12,8) on QPSK).  Header:
    Golay(24,12) BPSK.  Frame-detection loss is not modeled (≈0 above the
    waterfall).
    """
    g = 10.0 ** (snr_db / 10.0)          # SNR per complex sample
    if family == "gmsk":
        # k=2 samples/symbol, 1 bit/symbol => Eb/N0 = 2 * per-sample SNR;
        # coherent MSK bound
        p_raw = _qfunc(np.sqrt(2 * 2 * g))
        p_hdr = p_raw
        n_pay_blocks = 2 * (payload_len + 2)         # (7,4): 2 blocks/byte
        pay_ok = _block_code_ok(p_raw, 7, 1) ** n_pay_blocks
    elif family in ("ofdm", "flex"):
        if family == "flex":
            # k=2 samples/symbol QPSK: 1 sample/bit at matched filter
            gb = g
        else:
            from liquid_usrp_tpu.framing import ofdm as ofdm_mod
            params = ofdm_mod.make_ofdm_params(48, 6, 4)
            M, cp = params.M, params.cp_len
            n_act = len(params.data_idx) + len(params.pilot_idx)
            # per-subcarrier symbol energy: only the M FFT-window samples
            # are usable (CP energy is discarded), spread over n_act
            # active carriers; QPSK: /2 per bit
            gb = g * M / n_act / 2.0
        p_raw = _qfunc(np.sqrt(2 * gb))
        p_hdr = _qfunc(np.sqrt(2 * gb * 2.0))        # header is BPSK
        n_pay_blocks = payload_len + 4               # (12,8): 1 block/byte
        pay_ok = _block_code_ok(p_raw, 12, 1) ** n_pay_blocks
    else:
        raise ValueError(family)
    from liquid_usrp_tpu.framing import payload as pc
    # flex carries the reference's 14-byte user header; ofdm/gmsk use 8
    user_b = 14 if family == "flex" else pc.HEADER_USER_BYTES
    n_hdr_blocks = pc.header_enc_bytes(user_b) * 8 // 24
    hdr_ok = _block_code_ok(p_hdr, 24, 3) ** n_hdr_blocks
    return float(1.0 - hdr_ok * pay_ok)


def implementation_loss_db(results, family, payload_len,
                           per_level=0.01):
    """SNR gap (dB) between measured and theory waterfalls at a PER level."""
    snrs = np.array([r["snr_db"] for r in results])
    per = np.array([r["packet_error_rate"] for r in results])
    fine = np.arange(snrs.min(), snrs.max() + 0.01, 0.05)
    th = np.array([theory_per(family, s, payload_len) for s in fine])

    def cross(x, y):
        order = np.argsort(x)                 # sweep may be unsorted
        x, y = np.asarray(x)[order], np.asarray(y)[order]
        # tolerance: 1 - ok/n accumulates float error (199/200 missed
        # the 1e-2 level by 9e-18)
        idx = np.where(y <= per_level * (1 + 1e-9))[0]
        if not len(idx):
            return None
        i = idx[0]
        if i == 0 or y[i] <= 0:
            return float(x[i])
        # log-linear interpolation between the bracketing points: the
        # first-grid-point-below rule quantized the loss to the sweep's
        # SNR grid (a 1 dB bias at 1 dB spacing)
        y0, y1 = np.log(y[i - 1]), np.log(y[i])
        t = (np.log(per_level) - y0) / (y1 - y0)
        return float(x[i - 1] + t * (x[i] - x[i - 1]))

    m = cross(snrs, per)
    t = cross(fine, th)
    if m is None or t is None:
        return None
    return round(m - t, 2)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("family", choices=["ofdm", "flex", "gmsk"])
    ap.add_argument("--snrs", default="4,8,12,16,20,25")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--payload", type=int, default=200)
    ap.add_argument("--cfo", type=float, default=0.001)
    ap.add_argument("--json", default=None)
    ap.add_argument("--fec0", default=None,
                    help="override inner payload FEC (liquid name, e.g. "
                         "v27); conv names enable the runtime conv set")
    ap.add_argument("--fec1", default=None,
                    help="override outer payload FEC (liquid name)")
    ap.add_argument("--soft", action="store_true",
                    help="soft-decision LLRs into conv payload decode")
    args = ap.parse_args()
    snrs = [float(s) for s in args.snrs.split(",")]
    res = run_sweep(args.family, snrs, args.frames, args.payload, args.cfo,
                    fec0=args.fec0, fec1=args.fec1, soft=args.soft)
    for r in res:
        r["theory_per"] = round(
            theory_per(args.family, r["snr_db"], args.payload), 6)
    loss = implementation_loss_db(res, args.family, args.payload)
    print("implementation loss at 1% PER: "
          f"{loss} dB" if loss is not None else
          "implementation loss at 1% PER: not bracketed by sweep range")
    if args.json:
        # manifest: every committed curve traces to the commit + receiver
        # config that produced it
        import datetime
        import subprocess
        sha = subprocess.run(
            ["git", "-C", os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True).stdout.strip() or "unknown"
        out = {"rows": res, "impl_loss_db_at_1pct_per": loss,
               "manifest": {
                   "git_sha": sha,
                   "utc": datetime.datetime.now(
                       datetime.timezone.utc).isoformat(timespec="seconds"),
                   "family": args.family, "frames": args.frames,
                   "payload": args.payload, "cfo": args.cfo,
                   "fec0": args.fec0, "fec1": args.fec1, "soft": args.soft,
                   "cmd": " ".join(sys.argv)}}
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print("wrote", args.json)


if __name__ == "__main__":
    main()
