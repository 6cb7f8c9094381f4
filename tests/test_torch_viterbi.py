"""Viterbi decode of the PyTorch port (kernel K1's plain version on CPU
tensors) against the JAX package: decoded bits and path errors must be
bit-identical, ties included, for the FIC schedule, EEP and UEP MSC
schedules, batches past the Pallas kernel's 128-lane cap, noisy input and
the all-zero input where every candidate ties. The packed decisions are
also held against the Pallas ACS kernel run in interpret mode. The CUDA
kernels are held against these plain versions on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dab_radio_tpu.ops import viterbi as jvit
from dab_radio_tpu.params import (SubchannelConfig, fic_puncture_schedule,
                                  msc_puncture_schedule)
from dab_radio_tpu.params.puncture import build_puncture_mask
from dab_radio_tpu_torch.ops import viterbi as tvit
from dab_radio_tpu_torch.kernels import viterbi_acs

torch.set_num_threads(1)

SCHEDULES = {
    "fic": fic_puncture_schedule(),
    "eep3a_6cu": msc_puncture_schedule(
        SubchannelConfig(0, 6, False, eep_type="A", eep_prot_level=2)),
    "uep_idx1": msc_puncture_schedule(SubchannelConfig(0, 21, True,
                                                       uep_table_index=1)),
}


def _soft(schedule, B, noise, seed):
    """Encoded random messages of the schedule, as int8 soft symbols with
    Gaussian noise of std `noise` (clipped to +/-127)."""
    spec = jvit.ViterbiSpec.from_schedule(schedule)
    mask = build_puncture_mask(schedule)
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (B, spec.nb_data_bits)).astype(np.uint8)
    soft = np.stack([jvit.bits_to_soft(jvit.puncture(jvit.conv_encode(b), mask))
                     for b in bits]).astype(np.float64)
    soft = soft + rng.normal(0.0, noise, soft.shape)
    return np.clip(np.round(soft), -127, 127).astype(np.int8), bits


def _both(schedule, soft):
    js = jvit.ViterbiSpec.from_schedule(schedule)
    ts = tvit.ViterbiSpec.from_schedule(schedule)
    jb, je = jvit.viterbi_decode(jnp.asarray(soft), js)
    tb, te = tvit.viterbi_decode(torch.as_tensor(soft), ts)
    return (np.asarray(jb), np.asarray(je)), (tb.numpy(), te.numpy())


def test_tables_and_encoder_match_jax():
    np.testing.assert_array_equal(tvit._expected_outputs(),
                                  jvit._expected_outputs())
    bits = np.random.default_rng(0).integers(0, 2, 300)
    np.testing.assert_array_equal(tvit.conv_encode(bits), jvit.conv_encode(bits))
    for sched in SCHEDULES.values():
        js = jvit.ViterbiSpec.from_schedule(sched)
        ts = tvit.ViterbiSpec.from_schedule(sched)
        np.testing.assert_array_equal(ts.gather_idx, js.gather_idx)
        assert (ts.nb_in, ts.nb_steps, ts.nb_data_bits) == \
            (js.nb_in, js.nb_steps, js.nb_data_bits)
        soft = np.random.default_rng(1).integers(
            -127, 128, (2, ts.nb_in)).astype(np.int8)
        np.testing.assert_array_equal(
            tvit.depuncture(torch.as_tensor(soft), ts).numpy(),
            np.asarray(jvit.depuncture(jnp.asarray(soft), js)))


@pytest.mark.parametrize("name,B,noise", [
    ("fic", 4, 60.0),
    ("fic", 3, 0.0),
    ("eep3a_6cu", 130, 80.0),
    ("uep_idx1", 6, 70.0),
])
def test_decode_matches_jax(name, B, noise):
    soft, bits = _soft(SCHEDULES[name], B, noise, seed=B)
    (jb, je), (tb, te) = _both(SCHEDULES[name], soft)
    assert tb.dtype == np.int8 and te.dtype == np.int32
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(te, je)
    if noise == 0.0:
        np.testing.assert_array_equal(tb, bits)


@pytest.mark.parametrize("name", ["fic", "uep_idx1"])
def test_all_zero_input_ties_match_jax(name):
    ts = tvit.ViterbiSpec.from_schedule(SCHEDULES[name])
    soft = np.zeros((3, ts.nb_in), np.int8)
    (jb, je), (tb, te) = _both(SCHEDULES[name], soft)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(te, je)


def test_odd_trellis_length_matches_jax_radix2():
    """An odd T takes JAX's radix-2 path; the port has one path for both."""
    rng = np.random.default_rng(3)
    d = rng.integers(-127, 128, (5, 101, 4)).astype(np.int32)
    d[:, ::3, 2:] = 0
    jb, je = jvit.viterbi_decode_soft(jnp.asarray(d))
    tb, te = tvit.viterbi_decode_soft(torch.as_tensor(d))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def _unpack(dec: torch.Tensor) -> np.ndarray:
    """(T, B) int64 packed decisions -> (T, 64, B) 0/1."""
    shifts = torch.arange(64, dtype=torch.int64)
    return ((dec[:, None, :] >> shifts[None, :, None]) & 1).numpy()


def test_packed_decisions_match_pallas_interpret():
    from jax.experimental.pallas import tpu as pltpu
    from dab_radio_tpu.ops import viterbi_pallas as vp
    sched = SCHEDULES["fic"]
    soft, _ = _soft(sched, 4, 70.0, seed=11)
    js = jvit.ViterbiSpec.from_schedule(sched)
    T = js.nb_steps
    t_padded = -(-T // vp.T_CHUNK) * vp.T_CHUNK
    d = jnp.moveaxis(jvit.depuncture(jnp.asarray(soft), js), 0, -1)
    d = jnp.pad(d, ((0, t_padded - T), (0, 0), (0, vp.LANES - 4)))
    expected = jnp.asarray(jvit._expected_outputs().reshape(64, 8), jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(vp._build_acs(T, t_padded)(d, expected))[:T, :, :4]
    ts = tvit.ViterbiSpec.from_schedule(sched)
    dec, _ = viterbi_acs.viterbi_acs(
        tvit.depuncture(torch.as_tensor(soft), ts, dtype=torch.int8))
    np.testing.assert_array_equal(_unpack(dec), ref.astype(np.int64))


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        viterbi_acs.viterbi_acs(torch.zeros((2, 10, 4), dtype=torch.int8,
                                            device="meta"))
    with pytest.raises(ValueError):
        viterbi_acs.chainback(torch.zeros((10, 2), dtype=torch.int64,
                                          device="meta"))
