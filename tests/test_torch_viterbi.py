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


# ------------------------------------------------- the wrapper's dispatch

FUSED_SMEM = viterbi_acs.fused_smem_per_message


@pytest.mark.parametrize("B,T,route,per_block", [
    (4, 774, "fused", 1),            # FIC decode of one mode-I frame
    (72, 1542, "fused", 1),          # MSC group, 18 subchannels x 4 CIFs
    (1024, 1542, "fused", 8),        # 128 blocks of 8: one wave on 132 SMs
    (1152, 1542, "fused", 9),        # 16 streams of the 18-service ensemble
    (8, 9222, "fused", 1),           # a 384 kbit/s subchannel
    (2, 41478, "pair", 1),           # 864 CU at EEP 4-A
    (132, 1542, "fused", 1),         # as many messages as SMs
    (133, 1542, "fused", 2),
    (5000, 1542, "fused", 12),       # what a block's shared memory holds
    (5000, 100, "fused", 16),        # what a block's 16 warps hold
    (5000, 9222, "fused", 2),
    (1000, 41478, "pair", 8),
    (0, 774, "fused", 1),
    (4, 0, "fused", 1),
])
def test_plan_picks_route_and_messages_per_block(B, T, route, per_block):
    got_route, got_per_block, smem = viterbi_acs.plan(B, T)
    assert (got_route, got_per_block) == (route, per_block)
    assert smem % 16 == 0
    assert got_per_block * smem <= viterbi_acs.MAX_BLOCK_SMEM
    if route == "fused":
        # the ring, 8 bytes of decisions and 1 byte of bit per step
        assert smem == FUSED_SMEM(T) >= viterbi_acs.RING_BYTES + 9 * T
    else:
        assert smem == viterbi_acs.RING_BYTES


def test_plan_edge_of_shared_memory():
    last = viterbi_acs.MAX_FUSED_T
    assert last == 25372
    assert FUSED_SMEM(last) <= viterbi_acs.MAX_BLOCK_SMEM < FUSED_SMEM(last + 1)
    assert viterbi_acs.plan(1, last)[0] == "fused"
    assert viterbi_acs.plan(1, last + 1)[0] == "pair"
    # the route depends on T alone, the messages per block never exceed B's
    # share of an SM
    for B in (1, 72, 133, 10_000):
        assert viterbi_acs.plan(B, last)[:2] == ("fused", 1)
        assert viterbi_acs.plan(B, last + 1)[0] == "pair"
        assert viterbi_acs.plan(B, 1542)[1] <= max(1, -(-B // 132))


@pytest.mark.parametrize("B,T,kind", [
    (3, 100, "noise"), (3, 101, "noise"), (2, 16, "noise"), (2, 33, "noise"),
    (2, 64, "zero"), (2, 65, "zero"), (3, 48, "minus128"), (3, 49, "minus128"),
])
def test_kernel_decode_on_cpu_matches_jax(B, T, kind):
    """kernels.viterbi_acs.decode on CPU tensors (the plain versions) against
    the JAX main path's radix-4 decode (radix-2 for an odd T): even and odd
    T, an input where every candidate ties, and soft values of -128."""
    rng = np.random.default_rng(T)
    d = rng.integers(-127, 128, (B, T, 4)).astype(np.int8)
    d[:, ::3, 2:] = 0
    if kind == "zero":
        d[:] = 0
    elif kind == "minus128":
        d[rng.random(d.shape) < 0.3] = -128
    jdec = jvit.viterbi_decode_soft_radix4 if T % 2 == 0 \
        else jvit.viterbi_decode_soft
    jb, je = jdec(jnp.asarray(d.astype(np.int32)))
    tb, te = viterbi_acs.decode(torch.as_tensor(d))
    assert tb.dtype == torch.int8 and te.dtype == torch.int32
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_decode_wrappers_reject_what_is_neither_cpu_nor_cuda():
    d = torch.zeros((2, 10, 4), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        viterbi_acs.decode(d)
    with pytest.raises(ValueError):
        viterbi_acs.decode_fused(d)
    with pytest.raises(ValueError):                     # no CPU fused kernel
        viterbi_acs.decode_fused(torch.zeros((2, 10, 4), dtype=torch.int8))
