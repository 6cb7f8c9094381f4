"""StreamingDemodulator of the PyTorch port against the JAX package's, on
JAX-transmitter IQ through the JAX channel model (a CFO, an echo and AWGN),
for transmission modes I, II and IV.

Per frame step, sync_ok and the timing offset are exact; carry floats agree
to float32 rounding (stated below); soft bits may differ by 1 LSB on at
most 1e-4 of the values. The port also resumes from a JAX snapshot through
``convert.py``, and its batched step and multi-frame scan are held against
JAX's on the same windows.
"""

import numpy as np
import pytest
import torch

from dab_radio_tpu.models.channel import ChannelModel, EchoTap
from dab_radio_tpu.models.demodulator import (
    OFDMDemodulator as JDemod, StreamingDemodulator as JStream,
    DemodCarry as JCarry)
from dab_radio_tpu.models.transmitter import EnsembleTransmitter
from dab_radio_tpu_torch.convert import demod_state_from_jax
from dab_radio_tpu_torch.models.demodulator import (
    OFDMDemodulator as TDemod, StreamingDemodulator as TStream,
    DemodCarry as TCarry)
from tests.test_torch_ops import assert_soft_bits_close

torch.set_num_threads(1)

NB_FRAMES = {1: 5, 2: 10, 4: 6}
CFO_HZ = {1: 2345.0, 2: 1172.5, 4: 586.0}
# Soft bits through the streaming demodulator: the carried CFO estimates
# come from float32 FFTs and sums, so they differ from JAX's by an ulp or
# two. The PLL (JAX's and, mirrored, the port's) forms its phase in float32
# with t up to 2e5 (mode I) to 4e5 (mode IV) samples, so an ulp of CFO
# changes the phase's rounding pattern along the frame, and that moves up
# to ~2e-3 of a frame's soft bits by 1 LSB (measured: 1.3e-3 over a mode-I
# stream, 2.2e-3 in one mode-IV frame). Never by more than 1 LSB. On
# identical inputs the bound is 1e-4 (tests/test_torch_ops.py).
STREAM_FLIP_FRACTION = 5e-3
LEAD = 6000


def _capture(mode):
    tx = EnsembleTransmitter(mode)
    iq = tx.generate(NB_FRAMES[mode])
    lead = np.zeros(LEAD, np.complex64)
    iq = np.concatenate([lead, iq, lead])
    ch = ChannelModel(taps=[EchoTap(delay_us=30.0, gain_db=-6.0,
                                    phase_deg=40.0)],
                      cfo_hz=CFO_HZ[mode], snr_db=22.0, seed=mode,
                      snr_ref=(lead.shape[0], iq.shape[0] - lead.shape[0]))
    return ch.apply(iq)


def _record_steps(sd):
    """Wrap sd.demod.frame_step to record (sync_ok, offset, carry)."""
    steps = []
    inner = sd.demod.frame_step

    def step(carry, window):
        new_carry, out = inner(carry, window)
        steps.append((bool(out["sync_ok"]), int(out["offset"]),
                      [np.asarray(x) if not torch.is_tensor(x)
                       else x.numpy() for x in new_carry]))
        return new_carry, out
    sd.demod.frame_step = step
    return steps


def _compare_steps(js, ts):
    assert len(ts) == len(js) > 0
    for (jok, joff, jc), (tok, toff, tc) in zip(js, ts):
        assert (tok, toff) == (jok, joff)
        # coarse/fine CFO are normalised to the sample rate (~1e-3): float32
        # FFT and sum orders differ at ~1e-6 of a carrier spacing
        np.testing.assert_allclose(tc[0], jc[0], rtol=0, atol=1e-8)
        np.testing.assert_allclose(tc[1], jc[1], rtol=0, atol=1e-8)
        assert tc[2] == jc[2]
        np.testing.assert_allclose(tc[3], jc[3], rtol=1e-5)
        assert (tc[4], tc[5]) == (jc[4], jc[5])


def _feed(sd, iq, chunk=70000):
    frames = []
    for i in range(0, iq.shape[0], chunk):
        frames += sd.process(iq[i:i + chunk])
    return frames


@pytest.mark.parametrize("mode", [1, 2, 4])
def test_streaming_demodulator_matches_jax(mode):
    iq = _capture(mode)
    jsd, tsd = JStream(JDemod(mode)), TStream(TDemod(mode))
    jsteps, tsteps = _record_steps(jsd), _record_steps(tsd)
    jf, tf = _feed(jsd, iq), _feed(tsd, iq)
    _compare_steps(jsteps, tsteps)
    assert len(tf) == len(jf) >= NB_FRAMES[mode] - 1
    assert_soft_bits_close(np.stack(tf), np.stack(jf), STREAM_FLIP_FRACTION)
    assert int(tsd.carry.total_desync) == int(jsd.carry.total_desync)
    snap = tsd.snapshot()
    assert all(isinstance(x, np.ndarray) for x in snap["carry"])


def test_multi_frame_steps_match_jax():
    """frames_per_step > 1: K tracking steps per host read (frame_scan)."""
    iq = _capture(1)
    jsd, tsd = JStream(JDemod(1), 3), TStream(TDemod(1), 3)
    calls = []
    inner = tsd.demod.frame_scan
    tsd.demod.frame_scan = lambda *a: calls.append(1) or inner(*a)
    jf, tf = jsd.process(iq), tsd.process(iq)
    assert calls
    assert len(tf) == len(jf) >= NB_FRAMES[1] - 1
    assert_soft_bits_close(np.stack(tf), np.stack(jf), STREAM_FLIP_FRACTION)
    for t, j in zip(tsd.carry, jsd.carry):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-8)


def test_resume_from_jax_snapshot():
    iq = _capture(1)
    half = iq.shape[0] // 2
    jsd = JStream(JDemod(1))
    _feed(jsd, iq[:half])
    tsd = TStream(TDemod(1))
    tsd.restore(demod_state_from_jax(jsd.snapshot()))
    assert tsd.state == jsd.state and tsd._l1 == jsd._l1
    np.testing.assert_array_equal(tsd._buf.to_array(), jsd._buf.to_array())
    jsteps, tsteps = _record_steps(jsd), _record_steps(tsd)
    jf, tf = _feed(jsd, iq[half:]), _feed(tsd, iq[half:])
    _compare_steps(jsteps, tsteps)
    assert len(tf) == len(jf) >= 2
    assert_soft_bits_close(np.stack(tf), np.stack(jf), STREAM_FLIP_FRACTION)


def test_frame_step_batch_and_frame_scan_match_jax():
    iq = _capture(1)
    jd, td = JDemod(1), TDemod(1)
    # the capture's first null symbol starts after the lead
    start = LEAD - 100
    starts = [start, start + jd.frame_advance + 7]
    wins = np.stack([iq[s:s + jd.window_len] for s in starts])
    jc, jo = jd.frame_step_batch(JCarry.init((2,)), wins)
    tc, to = td.frame_step_batch(TCarry.init((2,)), wins)
    np.testing.assert_array_equal(to["sync_ok"].numpy(), np.asarray(jo["sync_ok"]))
    np.testing.assert_array_equal(to["offset"].numpy(), np.asarray(jo["offset"]))
    assert_soft_bits_close(to["bits"].numpy(), np.asarray(jo["bits"]),
                           STREAM_FLIP_FRACTION)
    K = 3
    buf = iq[start:start + K * jd.frame_advance + jd.window_len]
    jc, jpos, jouts = jd.frame_scan(K, JCarry.init(), buf)
    tc, tpos, touts = td.frame_scan(K, TCarry.init(), buf)
    assert int(tpos) == int(jpos)
    np.testing.assert_array_equal(touts["valid"].numpy(),
                                  np.asarray(jouts["valid"]))
    assert touts["valid"].numpy().all()
    assert_soft_bits_close(touts["bits"].numpy(), np.asarray(jouts["bits"]),
                           STREAM_FLIP_FRACTION)
    assert int(tc.total_frames) == int(jc.total_frames) == K
