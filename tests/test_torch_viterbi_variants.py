"""The decode variants of the PyTorch port against the JAX package, on the
CPU: the LUT branch metrics, the log-depth chainback, register exchange,
radix-8 and the overlap-save tiled decode. Decoded bits, path errors,
decisions and final metrics must be identical, ties included; the tiled
decode must give the JAX tiled decode's bits also where those differ from
the exact decode's. Inputs come from a numpy seed.

K1's windowed mode runs here as its plain PyTorch version; the CUDA kernel
is held against that version on the card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dab_radio_tpu.ops import viterbi as jvit
from dab_radio_tpu.params import fic_puncture_schedule
from dab_radio_tpu.params.puncture import build_puncture_mask
from dab_radio_tpu_torch.ops import viterbi as tvit
from dab_radio_tpu_torch.kernels import viterbi_acs

torch.set_num_threads(1)


def _encoded(B, T, noise, seed):
    """(B, T, 4) int8: random messages closed by the tail, encoded, with
    Gaussian noise of std `noise` and a third of the last two code bits of
    each step punctured to 0."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (B, T - 6)).astype(np.uint8)
    sym = np.stack([jvit.bits_to_soft(jvit.conv_encode(b)) for b in bits]
                   ).astype(np.float64).reshape(B, T, 4)
    sym = sym + rng.normal(0.0, noise, sym.shape)
    sym[:, :, 2:][rng.random((B, T, 2)) < 0.33] = 0.0
    return np.clip(np.round(sym), -127, 127).astype(np.int8), bits


def _input(kind, B, T, seed=0):
    if kind == "ties":
        return np.zeros((B, T, 4), np.int8)
    if kind == "random":
        return np.random.default_rng(seed).integers(
            -127, 128, (B, T, 4)).astype(np.int8)
    return _encoded(B, T, {"clean": 0.0, "noisy": 80.0, "heavy": 200.0}[kind],
                    seed)[0]


def _xs(d, r):
    """(B, T, 4) -> the state-major scan input of both packages."""
    B, T, _ = d.shape
    x = np.moveaxis(d.astype(np.float32), 1, 0).reshape(T // r, r, B, 4)
    return jnp.asarray(x), torch.as_tensor(x)


def _pm0(B, uniform=False):
    pm = np.full((64, B), 0 if uniform else jvit._INITIAL_NON_START, np.int32)
    pm[0] = 0
    return jnp.asarray(pm.astype(np.float32)), torch.as_tensor(pm)


def test_tables_match_jax():
    np.testing.assert_array_equal(tvit._branch_sign_matrix(),
                                  jvit._branch_sign_matrix())
    for a, b in zip(tvit._branch_pattern_lut(), jvit._branch_pattern_lut()):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert tvit._INITIAL_NON_START == jvit._INITIAL_NON_START
    assert tvit._STEP_ERR_OFFSET == jvit._STEP_ERR_OFFSET
    bits = np.random.default_rng(0).integers(0, 2, (3, 40))
    np.testing.assert_array_equal(tvit.pack_bits_msb(bits),
                                  jvit.pack_bits_msb(bits))


@pytest.mark.parametrize("branch", ["matmul", "lut"])
@pytest.mark.parametrize("kind,B,T", [("noisy", 5, 774), ("ties", 3, 96),
                                      ("random", 4, 1542), ("clean", 2, 60)])
def test_radix4_forward_matches_jax(kind, B, T, branch):
    jx, tx = _xs(_input(kind, B, T, seed=T), 2)
    jpm0, tpm0 = _pm0(B)
    jpm, jdec = jvit._radix4_forward_sm(jpm0, jx, branch=branch)
    tpm, tdec = tvit._radix4_forward_sm(tpm0, tx, branch=branch)
    assert tdec.dtype == torch.uint8 and tpm.dtype == torch.int32
    np.testing.assert_array_equal(tdec.numpy(), np.asarray(jdec))
    np.testing.assert_array_equal(tpm.numpy(), np.asarray(jpm).astype(np.int32))


@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.parametrize("anchors", ["zero", "mixed"])
def test_chainbacks_match_jax(r, anchors):
    """Sequential and log-depth chainback of radix-4 and radix-8 decisions
    against JAX's, from state 0 and from arbitrary anchors; the decisions
    are random ancestor indices (the maps need not come from a trellis)."""
    rng = np.random.default_rng(r)
    Tr, B = 37, 6
    dec = rng.integers(0, 1 << r, (Tr, 64, B)).astype(np.uint8)
    s0 = np.zeros(B, np.int32) if anchors == "zero" \
        else rng.integers(0, 64, B).astype(np.int32)
    jseq = (jvit._radix4_chainback_sm if r == 2 else jvit._radix8_chainback_sm)(
        jnp.asarray(dec), jnp.asarray(s0))
    jpar = jvit._chainback_parallel_sm(jnp.asarray(dec), jnp.asarray(s0), r)
    tseq = (tvit._radix4_chainback_sm if r == 2 else tvit._radix8_chainback_sm)(
        torch.as_tensor(dec), torch.as_tensor(s0))
    tpar = tvit._chainback_parallel_sm(torch.as_tensor(dec),
                                       torch.as_tensor(s0), r)
    assert tseq.dtype == torch.int8 and tpar.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(jseq), np.asarray(jpar))
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    np.testing.assert_array_equal(tpar.numpy(), np.asarray(jpar))


@pytest.mark.parametrize("branch", ["matmul", "lut"])
@pytest.mark.parametrize("kind,B,T", [("noisy", 4, 774), ("ties", 2, 70),
                                      ("random", 3, 320)])
def test_register_exchange_matches_jax(kind, B, T, branch):
    """History words, final metrics and the bits extracted at every anchor."""
    jx, tx = _xs(_input(kind, B, T, seed=7), 2)
    jpm0, tpm0 = _pm0(B, uniform=(kind == "random"))
    jpm, jh = jvit._radix4_forward_re(jpm0, jx, branch=branch)
    tpm, th = tvit._radix4_forward_re(tpm0, tx, branch=branch)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh).astype(np.int64))
    np.testing.assert_array_equal(tpm.numpy(), np.asarray(jpm).astype(np.int32))
    s0 = np.random.default_rng(1).integers(0, 64, B).astype(np.int32)
    np.testing.assert_array_equal(
        tvit._re_extract_bits(th, torch.as_tensor(s0), T).numpy(),
        np.asarray(jvit._re_extract_bits(jh, jnp.asarray(s0), T)))


@pytest.mark.parametrize("kind,B,T", [("noisy", 4, 774), ("ties", 2, 69),
                                      ("random", 3, 1542)])
def test_radix8_forward_matches_jax(kind, B, T):
    jx, tx = _xs(_input(kind, B, T, seed=8), 3)
    jpm0, tpm0 = _pm0(B)
    jpm, jdec = jvit._radix8_forward_sm(jpm0, jx)
    tpm, tdec = tvit._radix8_forward_sm(tpm0, tx)
    np.testing.assert_array_equal(tdec.numpy(), np.asarray(jdec))
    np.testing.assert_array_equal(tpm.numpy(), np.asarray(jpm).astype(np.int32))


@pytest.mark.parametrize("chainback,branch", [
    ("sequential", "matmul"), ("sequential", "lut"), ("parallel", "matmul"),
    ("parallel", "lut"), ("fused", "matmul"), ("fused", "lut")])
@pytest.mark.parametrize("kind,B,T", [("noisy", 3, 774), ("ties", 2, 774),
                                      ("noisy", 2, 1542), ("random", 2, 102)])
def test_radix4_decode_matches_jax(kind, B, T, chainback, branch):
    d = _input(kind, B, T, seed=T + B)
    jb, je = jvit.viterbi_decode_soft_radix4(
        jnp.asarray(d.astype(np.int32)), chainback=chainback, branch=branch)
    tb, te = tvit.viterbi_decode_soft_radix4(
        torch.as_tensor(d), chainback=chainback, branch=branch)
    assert tb.dtype == torch.int8 and te.dtype == torch.int32
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize("chainback", ["sequential", "parallel"])
@pytest.mark.parametrize("kind,B,T", [("noisy", 3, 774), ("ties", 2, 774),
                                      ("noisy", 2, 1542), ("random", 2, 102)])
def test_radix8_decode_matches_jax(kind, B, T, chainback):
    d = _input(kind, B, T, seed=T)
    jb, je = jvit.viterbi_decode_soft_radix8(
        jnp.asarray(d.astype(np.int32)), chainback=chainback)
    tb, te = tvit.viterbi_decode_soft_radix8(torch.as_tensor(d),
                                             chainback=chainback)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize("fn,kw", [
    ("viterbi_decode_soft", {}),
    ("viterbi_decode_soft_radix4", {}),
    ("viterbi_decode_soft_radix4", {"chainback": "parallel"}),
    ("viterbi_decode_soft_radix4", {"chainback": "fused", "branch": "lut"}),
    ("viterbi_decode_soft_radix8", {}),
    ("viterbi_decode_soft_radix8", {"chainback": "parallel"}),
])
def test_start_and_end_state_match_jax(fn, kw):
    """A message that starts in state 37 and is traced back from state 22,
    with a leading batch shape of (2, 2)."""
    d = _input("random", 4, 60, seed=5).reshape(2, 2, 60, 4)
    jb, je = getattr(jvit, fn)(jnp.asarray(d.astype(np.int32)),
                               start_state=37, end_state=22, **kw)
    tb, te = getattr(tvit, fn)(torch.as_tensor(d), start_state=37,
                               end_state=22, **kw)
    assert tuple(tb.shape) == (2, 2, 60) and tuple(te.shape) == (2, 2)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize("bad", [(64, 0), (0, 64), (-1, 0), (0, -1)])
def test_states_outside_the_trellis_raise(bad):
    d = torch.as_tensor(_input("random", 2, 20, seed=1))
    with pytest.raises(ValueError, match="0..63"):
        tvit.viterbi_decode_soft(d, *bad)
    with pytest.raises(ValueError, match="0..63"):
        tvit.viterbi_decode_soft_radix4(d, *bad)


TILED_FLAGS = [("sequential", "matmul"), ("sequential", "lut"),
               ("parallel", "matmul"), ("fused", "matmul"), ("fused", "lut")]


@pytest.mark.parametrize("chainback,branch", TILED_FLAGS)
@pytest.mark.parametrize("kind,B,T", [("clean", 2, 774), ("noisy", 3, 774),
                                      ("heavy", 3, 1542), ("ties", 2, 300)])
def test_tiled_decode_matches_jax(kind, B, T, chainback, branch):
    """Same windows and same anchors: the JAX tiled decode's bits exactly,
    at every noise level."""
    d = _input(kind, B, T, seed=3 * T)
    jb, jerr = jvit.viterbi_decode_soft_tiled(
        jnp.asarray(d.astype(np.int32)), chainback=chainback, branch=branch)
    tb, terr = tvit.viterbi_decode_soft_tiled(
        torch.as_tensor(d), chainback=chainback, branch=branch)
    assert jerr is None and terr is None and tb.dtype == torch.int8
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_tiled_decode_differs_from_exact_under_heavy_noise_as_jax_does():
    """The accuracy contract is JAX's: where the tiled decode leaves the
    exact one, the port leaves it at the same bits."""
    d = _input("heavy", 6, 1542, seed=99)
    exact = np.asarray(jvit.viterbi_decode_soft_radix4(
        jnp.asarray(d.astype(np.int32)))[0])
    jb = np.asarray(jvit.viterbi_decode_soft_tiled(
        jnp.asarray(d.astype(np.int32)))[0])
    tb = tvit.viterbi_decode_soft_tiled(torch.as_tensor(d))[0].numpy()
    assert (jb != exact).any()
    np.testing.assert_array_equal(tb, jb)
    clean, bits = _encoded(2, 774, 0.0, seed=4)
    got = tvit.viterbi_decode_soft_tiled(torch.as_tensor(clean))[0].numpy()
    np.testing.assert_array_equal(got[:, :768], bits)


@pytest.mark.parametrize("chunk,overlap", [(128, 96), (64, 32), (200, 20)])
def test_tiled_chunk_and_overlap_match_jax(chunk, overlap):
    d = _input("noisy", 2, 774, seed=chunk)
    jb, _ = jvit.viterbi_decode_soft_tiled(jnp.asarray(d.astype(np.int32)),
                                           chunk=chunk, overlap=overlap)
    tb, _ = tvit.viterbi_decode_soft_tiled(torch.as_tensor(d), chunk=chunk,
                                           overlap=overlap)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("kind", ["noisy", "heavy", "ties"])
def test_windowed_plain_matches_tiled_torch(kind):
    """K1's windowed plain version (radix-2, argmin anchor) against the
    radix-4 torch algorithm over the same windows."""
    d = torch.as_tensor(_input(kind, 3, 774, seed=21))
    via_k1, _ = tvit.viterbi_decode_soft_tiled(d)
    via_torch, _ = tvit.viterbi_decode_soft_tiled(d, chainback="parallel")
    assert torch.equal(via_k1, via_torch)
    # the windows themselves, first tiles and interior tiles mixed
    rng = np.random.default_rng(5)
    w = torch.as_tensor(rng.integers(-127, 128, (9, 320, 4)).astype(np.int8))
    first = torch.as_tensor(rng.random(9) < 0.4)
    got = viterbi_acs.decode_windows(w, first)
    pm0 = viterbi_acs.start_metrics(9, "cpu", first).T.contiguous()
    _, want = tvit._radix4_bits(pm0, tvit._steps_sm(w, 2), 320, "sequential",
                                "lut", None)
    assert got.dtype == torch.int8 and torch.equal(got, want.T)


def test_best_state_takes_the_lowest_of_equal_metrics():
    pm = torch.tensor([[5] * 64, [7] * 10 + [-3, -3] + [7] * 52,
                       list(range(63, -1, -1))], dtype=torch.int32)
    pm[0, 40:] = -100000
    assert viterbi_acs.best_state(pm).tolist() == [40, 10, 63]
    jpm = jnp.asarray(pm.numpy().T.astype(np.float32))
    assert np.asarray(jnp.argmin(jpm, axis=0)).tolist() == [40, 10, 63]


@pytest.mark.parametrize("chainback,branch", [
    ("sequential", "matmul"), ("parallel", "matmul"), ("fused", "lut")])
def test_viterbi_decode_with_flags_matches_jax(chainback, branch):
    sched = fic_puncture_schedule()
    js = jvit.ViterbiSpec.from_schedule(sched)
    ts = tvit.ViterbiSpec.from_schedule(sched)
    mask = build_puncture_mask(sched)
    rng = np.random.default_rng(12)
    bits = rng.integers(0, 2, (3, js.nb_data_bits)).astype(np.uint8)
    soft = np.stack([jvit.bits_to_soft(jvit.puncture(jvit.conv_encode(b), mask))
                     for b in bits]).astype(np.float64)
    soft = np.clip(np.round(soft + rng.normal(0, 70.0, soft.shape)),
                   -127, 127).astype(np.int8)
    jb, je = jvit.viterbi_decode(jnp.asarray(soft), js, chainback=chainback,
                                 branch=branch)
    tb, te = tvit.viterbi_decode(torch.as_tensor(soft), ts,
                                 chainback=chainback, branch=branch)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    jt, _ = jvit.viterbi_decode_tiled(jnp.asarray(soft), js,
                                      chainback=chainback)
    tt, none = tvit.viterbi_decode_tiled(torch.as_tensor(soft), ts,
                                         chainback=chainback)
    assert none is None
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    one, _ = tvit.viterbi_decode_tiled(torch.as_tensor(soft[0]), ts)
    np.testing.assert_array_equal(one.numpy(), np.asarray(jt)[0])


def test_flags_are_checked():
    d = torch.zeros((2, 12, 4), dtype=torch.int8)
    with pytest.raises(ValueError):
        tvit.viterbi_decode_soft_radix4(d, chainback="log")
    with pytest.raises(ValueError):
        tvit.viterbi_decode_soft_radix4(d, branch="table")
    with pytest.raises(ValueError):
        tvit.viterbi_decode_soft_radix8(d, chainback="fused")
    with pytest.raises(ValueError):
        tvit.viterbi_decode_soft_radix8(d[:, :10])
    with pytest.raises(ValueError):
        tvit.viterbi_decode_soft_radix4(d[:, :11], chainback="parallel")
    with pytest.raises(ValueError):
        tvit.viterbi_decode_soft_tiled(d, chunk=7)
    with pytest.raises(ValueError):
        tvit.viterbi_decode_soft_tiled(d[0])
    with pytest.raises(ValueError):                 # mask on another device
        viterbi_acs.decode_windows(d, torch.zeros(2, dtype=torch.bool,
                                                  device="meta"))
    with pytest.raises(ValueError):                 # not a bool mask
        viterbi_acs.decode_windows(d, torch.zeros(2, dtype=torch.uint8))
    with pytest.raises(ValueError):                 # neither CPU nor CUDA
        viterbi_acs.decode_windows(
            d.to("meta"), torch.zeros(2, dtype=torch.bool, device="meta"))


def test_plan_and_counters_cover_the_windowed_entry():
    assert "viterbi_decode_windows" in viterbi_acs.LAUNCHES
    # 126,464 windows of 320 steps: 16 a block, two blocks an SM
    route, per_block, smem = viterbi_acs.plan(126464, 320)
    assert (route, per_block) == ("fused", 16)
    assert smem == viterbi_acs.fused_smem_per_message(320) == 4096 + 2880
    assert viterbi_acs.plan(28, 320)[:2] == ("fused", 1)
    # the plain version counts nothing
    viterbi_acs.reset_launches()
    viterbi_acs.decode_windows(torch.zeros((2, 32, 4), dtype=torch.int8),
                               torch.tensor([True, False]))
    assert not any(viterbi_acs.LAUNCHES.values())
    assert not viterbi_acs.ACS_LAUNCHES_BY_T
