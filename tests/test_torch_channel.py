"""The port's channel simulator (``dab_radio_tpu_torch/models/channel.py``, a
numpy copy) against the JAX package's, on the same seeded input.

Each impairment alone and all together (AWGN, CFO, a static echo, a Rayleigh
tap, a deterministic Doppler tap, sample-clock drift): the output is
bit-identical, since both sides run the same numpy code with the same seed.
``parse_echo_spec`` is held on the grammar cases of tests/test_channel.py.
"""

import numpy as np
import pytest

from dab_radio_tpu.models import channel as jch
from dab_radio_tpu_torch.models import channel as tch

N = 40000


def _signal(seed=1):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=N) + 1j * rng.normal(size=N)) / np.sqrt(2)
            ).astype(np.complex64)


CASES = {
    "awgn": dict(snr_db=6.0),
    "cfo": dict(cfo_hz=1234.5),
    "static_echo": dict(taps=[dict(delay_us=100.0, gain_db=-6.0)]),
    "echo_phase_and_direct_gain": dict(
        taps=[dict(delay_us=37.3, gain_db=-3.0, phase_deg=45.0)],
        direct_gain_db=-1.5),
    "rayleigh": dict(taps=[dict(delay_us=5.0, gain_db=-1.0, doppler_hz=40.0,
                                rayleigh=True)], snr_db=20.0),
    "doppler_tap": dict(taps=[dict(delay_us=12.0, gain_db=-8.0,
                                   doppler_hz=25.0)]),
    "no_direct_path": dict(taps=[dict(delay_us=3.5, gain_db=0.0)],
                           direct=False),
    "drift": dict(drift_ppm=35.0),
    "all": dict(taps=[dict(delay_us=240.0, gain_db=-3.0),
                      dict(delay_us=5.0, gain_db=-1.0, doppler_hz=60.0,
                           rayleigh=True)],
                cfo_hz=-700.0, drift_ppm=-12.0, snr_db=10.0,
                snr_ref=(1000, 30000)),
}


def _model(pkg, seed, kw):
    kw = dict(kw)
    taps = [pkg.EchoTap(**t) for t in kw.pop("taps", [])]
    return pkg.ChannelModel(taps=taps, seed=seed, **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_channel_is_bit_identical_to_jax(name):
    x = _signal()
    want = _model(jch, 7, CASES[name]).apply(x)
    got = _model(tch, 7, CASES[name]).apply(x)
    assert got.dtype == want.dtype == np.complex64
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    if name != "no_direct_path" and "drift" not in CASES[name]:
        assert not np.array_equal(got, x)          # the impairment acted


def test_helpers_are_bit_identical_to_jax():
    frac = np.linspace(0, 0.999, 17)
    assert tch._frac_delay_kernel(frac).tobytes() == \
        jch._frac_delay_kernel(frac).tobytes()
    x, pos = _signal(3)[:5000], np.arange(4000) * 1.137 + 3.3
    assert tch._interp_at(x, pos).tobytes() == jch._interp_at(x, pos).tobytes()
    g = [m._jakes_gains(9000, 80.0, 2.048e6, np.random.default_rng(5))
         for m in (tch, jch)]
    assert g[0].tobytes() == g[1].tobytes()


@pytest.mark.parametrize("spec", ["100:-3, 240:-6:40:r,5:-1:25", "240:-3",
                                  "5:-1:40:rayleigh", "7:-2::1", " ,12:-9,",
                                  "3.5:0:10:true,8:-4:0:no"])
def test_parse_echo_spec_matches_jax(spec):
    want = jch.parse_echo_spec(spec)
    got = tch.parse_echo_spec(spec)
    assert [repr(t) for t in got] == [repr(t) for t in want]
    assert [t.amplitude for t in got] == [t.amplitude for t in want]


@pytest.mark.parametrize("spec", ["100", "abc:1", "1:x"])
def test_parse_echo_spec_rejects_what_jax_rejects(spec):
    with pytest.raises(ValueError):
        jch.parse_echo_spec(spec)
    with pytest.raises(ValueError):
        tch.parse_echo_spec(spec)
