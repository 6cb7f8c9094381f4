"""The port's ``ber_sweep`` against the JAX package's, in process on the
CPU: ``run_point`` at mode II, 3 frames, SNR 2 and 14 dB, CFO 1200 Hz, and
once with an echo of 100 us at -6 dB; then ``main``'s CSV.

Tolerances: locked_frames, desync, vit_byte_err and fib_crc_rate are
equal; raw_ber and first_frame_ber agree within 5e-3 absolute (ROADMAP F3:
an ulp of carried CFO moves a soft bit by 1 LSB, and a hard decision flips
only where that crosses 0).
"""

import io
import sys

import pytest

from dab_radio_tpu.apps import ber_sweep as j_ber
from dab_radio_tpu.models.channel import parse_echo_spec as j_echo
from dab_radio_tpu_torch.apps import ber_sweep as t_ber
from dab_radio_tpu_torch.models.channel import parse_echo_spec as t_echo

POINTS = {"snr2": (2.0, ""), "snr14": (14.0, ""), "snr14_echo": (14.0,
                                                                 "100:-6")}


@pytest.mark.parametrize("name", list(POINTS))
def test_run_point_matches_jax(name):
    snr, echo = POINTS[name]
    want = j_ber.run_point(2, snr, 1200.0, 3,
                           taps=j_echo(echo) if echo else ())
    got = t_ber.run_point(2, snr, 1200.0, 3,
                          taps=t_echo(echo) if echo else (), device="cpu")
    assert sorted(got) == sorted(want)
    for k in ("snr_db", "locked_frames", "desync", "vit_byte_err",
              "fib_crc_rate"):
        assert got[k] == want[k], k
    for k in ("raw_ber", "first_frame_ber"):
        assert abs(got[k] - want[k]) <= 5e-3, k
    if snr == 2.0:
        assert got["locked_frames"] == 0
    else:
        assert got["locked_frames"] >= 2 and got["vit_byte_err"] == 0.0
        assert got["fib_crc_rate"] == 1.0


def _csv(main, argv):
    out, saved = io.StringIO(), sys.stdout
    sys.stdout = out
    try:
        assert main(argv) == 0
    finally:
        sys.stdout = saved
    return out.getvalue().splitlines()


def test_main_prints_the_same_table():
    argv = ["-M", "2", "--snr", "14", "--cfo", "-800", "-n", "3",
            "--drift-ppm", "1", "--seed", "3"]
    want = _csv(j_ber.main, argv)
    got = _csv(t_ber.main, argv + ["--backend", "cpu"])
    assert got[0] == want[0] == ("snr_db,locked_frames,raw_ber,"
                                 "first_frame_ber,vit_byte_err,fib_crc_rate,"
                                 "desync")
    assert len(got) == len(want) == 2
    g, w = got[1].split(","), want[1].split(",")
    assert [g[i] for i in (0, 1, 4, 5, 6)] == [w[i] for i in (0, 1, 4, 5, 6)]
    assert abs(float(g[2]) - float(w[2])) <= 5e-3
