"""End-to-end app-pair tests: the reference's paired-loopback validation
idiom (SURVEY.md §4.1) over IQ files and virtual-air channels."""
import io
import contextlib

import numpy as np
import pytest


def _capture(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def test_flexframe_pair(tmp_path):
    from liquid_usrp_tpu.apps import flexframe_rx, flexframe_tx
    f = str(tmp_path / "flex.iq")
    rc, _ = _capture(flexframe_tx.main,
                     ["-o", f, "-N", "3", "-P", "80", "-r", "2.0"])
    assert rc == 0
    rc, out = _capture(flexframe_rx.main,
                       ["-i", f, "-r", "0.5", "-p", "256",
                        "--snr", "25"])
    assert rc == 0
    assert "valid packets       :      3 (100.00%)" in out


def test_packet_pair(tmp_path):
    from liquid_usrp_tpu.apps import packet_rx, packet_tx
    f = str(tmp_path / "pkt.iq")
    rc, _ = _capture(packet_tx.main, ["-o", f, "-N", "2", "-r", "2.0"])
    assert rc == 0
    rc, out = _capture(packet_rx.main, ["-i", f, "-r", "0.5"])
    assert rc == 0
    assert "valid packets       :      2 (100.00%)" in out
    assert "rx frame64" in out


def test_gmsk_pair(tmp_path):
    from liquid_usrp_tpu.apps import gmskframe_rx, gmskframe_tx
    f = str(tmp_path / "gmsk.iq")
    rc, _ = _capture(gmskframe_tx.main,
                     ["-o", f, "-N", "2", "-P", "100"])
    assert rc == 0
    rc, out = _capture(gmskframe_rx.main,
                       ["-i", f, "-p", "256", "--snr", "22"])
    assert rc == 0
    assert "valid packets       :      2 (100.00%)" in out
    assert "packet error rate" in out


def test_multichannel_pair(tmp_path):
    from liquid_usrp_tpu.apps import multichannel_rx, multichannel_tx
    f = str(tmp_path / "mc.iq")
    rc, _ = _capture(multichannel_tx.main,
                     ["-o", f, "-n", "2", "-N", "1", "-P", "64"])
    assert rc == 0
    rc, out = _capture(multichannel_rx.main, ["-i", f, "-n", "2"])
    assert rc == 0
    assert "valid packets       :      2 (100.00%)" in out


def test_narrowband_asgram_rssi(tmp_path):
    from liquid_usrp_tpu.apps import asgram_rx, narrowband_tx, rssi
    f = str(tmp_path / "nb.iq")
    rc, out = _capture(narrowband_tx.main,
                       ["-o", f, "-n", "2048", "-t", "rrcos"])
    assert rc == 0
    rc, out = _capture(asgram_rx.main, ["-i", f, "-L", "4"])
    assert rc == 0
    assert "peak:" in out
    m = str(tmp_path / "rssi_log.m")
    rc, out = _capture(rssi.main, ["-i", f, "-L", "2048", "-o", m])
    assert rc == 0
    assert "rssi =" in out
    assert "figure; plot(rssi)" in open(m).read()


def test_rssi_asgram_msresamp_stage(tmp_path):
    """-r inserts the reference's recv->msresamp->measurement stage
    (rssi.cc:112, asgram_rx.cc:131): a CW tone at f0 measured through
    rate r must keep its RSSI and move its spectral peak to f0/r."""
    from liquid_usrp_tpu.apps import asgram_rx, rssi
    from liquid_usrp_tpu.apps.common import apply_msresamp
    n = 16384
    f0 = 0.15   # in-band through the rate-0.5 anti-alias lowpass
    tone = np.exp(2j * np.pi * f0 * np.arange(n)).astype(np.complex64)
    f = str(tmp_path / "tone.iq")
    tone.tofile(f)
    rc, out = _capture(rssi.main, ["-i", f, "-r", "0.5", "-L", "2048"])
    assert rc == 0
    vals = [float(l.split("=")[1].split("dB")[0])
            for l in out.splitlines() if "rssi =" in l]
    assert vals and all(abs(v) < 1.5 for v in vals[1:])  # unit power
    rc, out = _capture(asgram_rx.main,
                       ["-i", f, "-r", "0.5", "-L", "4", "-n", "64"])
    assert rc == 0
    peaks = [float(l.split("f=")[1]) for l in out.splitlines() if "f=" in l]
    assert peaks and all(abs(p - 0.30) < 0.05 for p in peaks)  # 0.15 / 0.5
    rc, out = _capture(asgram_rx.main,
                       ["-i", f, "-r", "2.0", "-L", "4", "-n", "64"])
    assert rc == 0
    peaks = [float(l.split("f=")[1]) for l in out.splitlines() if "f=" in l]
    assert peaks and all(abs(p - 0.075) < 0.05 for p in peaks)  # 0.15 * 0.5


@pytest.mark.slow
def test_halfduplex(tmp_path):
    from liquid_usrp_tpu.apps import halfduplex_txrx
    rc, out = _capture(halfduplex_txrx.main,
                       ["-N", "2", "-P", "32", "--snr", "30"])
    assert rc == 0
    assert "2/2 delivered" in out


def test_usage_screens():
    """Every app prints usage with -h and exits 0 (getopt parity)."""
    from liquid_usrp_tpu.apps import (asgram_rx, flexframe_rx, flexframe_tx,
                                      fullduplex_txrx, gmskframe_rx,
                                      gmskframe_tx, halfduplex_txrx,
                                      multichannel_rx, multichannel_tx,
                                      multichannel_txrx, narrowband_tx,
                                      ofdmflexframe_rx, ofdmflexframe_tx,
                                      packet_rx, packet_tx, rssi)
    for mod in (asgram_rx, flexframe_rx, flexframe_tx, fullduplex_txrx,
                gmskframe_rx, gmskframe_tx, halfduplex_txrx,
                multichannel_rx, multichannel_tx, multichannel_txrx,
                narrowband_tx, ofdmflexframe_rx, ofdmflexframe_tx,
                packet_rx, packet_tx, rssi):
        rc, out = _capture(mod.main, ["-h"])
        assert rc == 0, mod.__name__
        assert "usage" in out or "options" in out, mod.__name__


def test_bad_flag_exits_cleanly():
    """Unknown flags exit 1 with a one-line error (not a traceback)."""
    from liquid_usrp_tpu.apps import ofdmflexframe_tx
    with pytest.raises(SystemExit) as exc:
        ofdmflexframe_tx.main(["-Z"])
    assert exc.value.code == 1


@pytest.mark.slow
def test_fullduplex_behavior():
    """Both directions decode over the derived-CFO duplex links, and -R
    measurably swaps the carrier-role plan."""
    from liquid_usrp_tpu.apps import fullduplex_txrx
    rc, out = _capture(fullduplex_txrx.main,
                       ["-N", "2", "-P", "64", "-q"])
    assert rc == 0
    assert "A tx 462.0 MHz / rx 562.0 MHz" in out
    rc_r, out_r = _capture(fullduplex_txrx.main,
                           ["-N", "2", "-P", "64", "-q", "-R"])
    assert rc_r == 0
    assert "A tx 562.0 MHz / rx 462.0 MHz" in out_r
    # derived CFO signs/magnitudes swap with the role plan
    import re
    cfos = re.findall(r"derived cfo\s+: ([+-]\d\.\d+)", out)
    cfos_r = re.findall(r"derived cfo\s+: ([+-]\d\.\d+)", out_r)
    assert len(cfos) == 2 and len(cfos_r) == 2
    assert cfos != cfos_r


@pytest.mark.slow
def test_multichannel_txrx_two_endpoint_tdd():
    """Two-endpoint TDD: every packet payload-exact at the far endpoint
    across alternating rounds (rc enforces the payload-exact count)."""
    from liquid_usrp_tpu.apps import multichannel_txrx
    rc, out = _capture(multichannel_txrx.main,
                       ["-n", "2", "-R", "2", "-P", "80", "-q"])
    assert rc == 0
    assert "payload-exact       :      8 / 8 sent" in out
