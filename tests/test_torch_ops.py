"""Signal ops of the PyTorch port against the JAX package on the same
complex64 input: PLL, every sync op, the frame-body demod and the time
deinterleaver.

Tolerances: integer outputs (argmax indices, found flags, offsets) are
exact; floats agree to float32 rounding of different FFT and reduction
orders (stated per check); int8 soft bits may differ by 1 LSB on at most
1e-4 of the values (FFT rounding) and never by more.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dab_radio_tpu.ops import sync as jsync
from dab_radio_tpu.ops.pll import apply_pll as j_apply_pll
from dab_radio_tpu.ops.demod import demod_frame_body as j_demod
from dab_radio_tpu.ops import deinterleave as jdi
from dab_radio_tpu.params import get_ofdm_params, get_prs_reference
from dab_radio_tpu.params.mapper import get_carrier_mapper, get_carrier_to_fft_bin
from dab_radio_tpu_torch.ops import sync as tsync
from dab_radio_tpu_torch.ops.pll import apply_pll as t_apply_pll
from dab_radio_tpu_torch.ops.demod import demod_frame_body as t_demod
from dab_radio_tpu_torch.ops import deinterleave as tdi

torch.set_num_threads(1)


def assert_soft_bits_close(a, b, max_fraction=1e-4):
    """int8 soft bits: |a - b| <= 1 everywhere, != on at most max_fraction
    of the values (1e-4 on identical inputs: FFT rounding)."""
    diff = np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16))
    assert diff.max() <= 1
    assert (diff != 0).mean() <= max_fraction


def _c64(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
            ).astype(np.complex64)


def _tx_frame(mode=1, cfo_bins=0.0, seed=0):
    """One modulated frame of random bits, with a CFO of cfo_bins spacings."""
    from dab_radio_tpu.models.modulator import OFDMModulator
    p = get_ofdm_params(mode)
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (p.nb_data_symbols, 2 * p.nb_data_carriers))
    iq = np.asarray(OFDMModulator(mode).modulate_frame(
        jnp.asarray(bits.astype(np.uint8))), np.complex64)
    n = np.arange(iq.shape[0])
    iq = iq * np.exp(2j * np.pi * cfo_bins / p.nb_fft * n)
    iq = iq + 0.05 * _c64(rng, iq.shape[0]) * np.abs(iq).mean()
    return iq.astype(np.complex64), p


@pytest.mark.parametrize("freq,t0", [(0.0123, 0.0), (-0.31, 1234.0),
                                     (0.5, 150000.0)])
def test_apply_pll_matches_jax(freq, t0):
    x = _c64(np.random.default_rng(1), 3, 4096)
    ref = np.asarray(j_apply_pll(jnp.asarray(x), jnp.float32(freq), t0))
    got = t_apply_pll(torch.as_tensor(x), torch.tensor(freq), t0).numpy()
    # phase reaches ~1e6 rad: float32 sin/cos of two libraries agree to
    # a few ulps of that argument's reduction
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_l1_average_and_find_null_dip_match_jax():
    iq, p = _tx_frame()
    block = np.concatenate([iq[-60000:], iq, iq[:20000]])
    blocks = np.stack([block, np.roll(block, 7777), np.roll(block, -3000)])
    l1_j = np.asarray(jsync.l1_average(jnp.asarray(blocks)))
    l1_t = tsync.l1_average(torch.as_tensor(blocks)).numpy()
    np.testing.assert_allclose(l1_t, l1_j, rtol=1e-5)
    fj, ej = jsync.find_null_dip(jnp.asarray(blocks), jnp.asarray(l1_j))
    ft, et = tsync.find_null_dip(torch.as_tensor(blocks),
                                 torch.as_tensor(l1_j.copy()))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    assert ft.numpy().all()
    # no dip in pure noise: found is False for both
    noise = _c64(np.random.default_rng(2), 20000)
    l1n = np.asarray(jsync.l1_average(jnp.asarray(noise)))
    fj, ej = jsync.find_null_dip(jnp.asarray(noise), jnp.asarray(l1n))
    ft, et = tsync.find_null_dip(torch.as_tensor(noise),
                                 torch.as_tensor(l1n.copy()))
    assert bool(ft) == bool(fj) and int(et) == int(ej)


def test_relative_phase_and_prs_ref_match_jax():
    x = _c64(np.random.default_rng(3), 2, 2048)
    np.testing.assert_allclose(
        tsync._relative_phase(torch.as_tensor(x)).numpy(),
        np.asarray(jsync._relative_phase(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    prs = get_prs_reference(1, 2048)
    np.testing.assert_array_equal(tsync.make_prs_time_correlation_ref(prs),
                                  jsync.make_prs_time_correlation_ref(prs))


@pytest.mark.parametrize("cfo_bins", [0.0, 3.3, -7.45])
def test_coarse_freq_estimate_and_update_match_jax(cfo_bins):
    iq, p = _tx_frame(cfo_bins=cfo_bins, seed=4)
    prs = get_prs_reference(1, p.nb_fft)
    ref = jsync.make_prs_time_correlation_ref(prs)
    prs_rx = iq[p.nb_null_period:p.nb_null_period + p.nb_fft]
    pj = np.asarray(jsync.coarse_freq_estimate(jnp.asarray(prs_rx),
                                               jnp.asarray(ref), p.nb_fft))
    pt = tsync.coarse_freq_estimate(torch.as_tensor(prs_rx),
                                    torch.as_tensor(ref), p.nb_fft).numpy()
    # a lerp of three FFT magnitudes: float32 FFT rounding, ~1e-6 of a bin
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6 / p.nb_fft)
    assert round(float(pt) * p.nb_fft) == round(-cfo_bins)
    for coarse, found in [(0.0, False), (float(pj) + 0.2 / p.nb_fft, True),
                          (float(pj) + 3.0 / p.nb_fft, True)]:
        cj, dj = jsync.coarse_freq_update(jnp.float32(pj), jnp.float32(coarse),
                                          jnp.bool_(found), p.nb_fft)
        ct, dt = tsync.coarse_freq_update(torch.tensor(float(pj)),
                                          torch.tensor(coarse),
                                          torch.tensor(found), p.nb_fft)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                                   atol=1e-12)


@pytest.mark.parametrize("shift", [0, 17, -30])
def test_fine_time_offset_matches_jax(shift):
    iq, p = _tx_frame(cfo_bins=0.2, seed=5)
    prs = get_prs_reference(1, p.nb_fft)
    prs_conj = np.conj(prs).astype(np.complex64)
    start = p.nb_null_period + shift
    prs_rx = np.stack([iq[start:start + p.nb_fft],
                       _c64(np.random.default_rng(6), p.nb_fft)])
    f = np.float32(-0.2 / p.nb_fft)
    oj, sj, ij = jsync.fine_time_offset(
        jnp.asarray(prs_rx), jnp.asarray(prs_conj), jnp.asarray([f, f]),
        p.nb_fft, p.nb_cyclic_prefix, p.nb_symbol_period)
    ot, st, it = tsync.fine_time_offset(
        torch.as_tensor(prs_rx), torch.as_tensor(prs_conj),
        torch.tensor([f, f]), p.nb_fft, p.nb_cyclic_prefix,
        p.nb_symbol_period)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert bool(st[0]) and not bool(st[1])
    # impulse response, compared as linear magnitude: float32 FFT rounding
    # is relative to the peak, and dB magnifies it on near-empty bins
    mt, mj = 10 ** (it.numpy() / 20), 10 ** (np.asarray(ij) / 20)
    assert (np.abs(mt - mj)
            <= 1e-4 * mj + 1e-5 * mj.max(axis=-1, keepdims=True)).all()


def test_cyclic_and_fine_freq_ops_match_jax():
    iq, p = _tx_frame(cfo_bins=0.11, seed=7)
    body = iq[p.nb_null_period:p.nb_null_period
              + p.nb_frame_symbols * p.nb_symbol_period]
    syms = body.reshape(p.nb_frame_symbols, p.nb_symbol_period)
    ej = np.asarray(jsync.cyclic_phase_error(jnp.asarray(syms), p.nb_fft,
                                             p.nb_cyclic_prefix))
    et = tsync.cyclic_phase_error(torch.as_tensor(syms), p.nb_fft,
                                  p.nb_cyclic_prefix).numpy()
    np.testing.assert_allclose(et, ej, rtol=1e-5)
    np.testing.assert_allclose(
        tsync.fine_freq_error(torch.as_tensor(et), p.nb_fft).numpy(),
        np.asarray(jsync.fine_freq_error(jnp.asarray(et), p.nb_fft)),
        rtol=1e-6)
    f = np.array([0.0, 0.2, 0.5, -0.51, 2.7, -3.49], np.float32) / p.nb_fft
    np.testing.assert_array_equal(
        tsync.wrap_fine_offset(torch.as_tensor(f), p.nb_fft).numpy(),
        np.asarray(jsync.wrap_fine_offset(jnp.asarray(f), p.nb_fft)))


@pytest.mark.parametrize("mode,symbol_chunk", [(1, 0), (1, 19), (2, 0)])
def test_demod_frame_body_matches_jax(mode, symbol_chunk):
    iq, p = _tx_frame(mode=mode, cfo_bins=0.07, seed=8)
    body = iq[p.nb_null_period:p.nb_null_period
              + p.nb_frame_symbols * p.nb_symbol_period]
    body = np.stack([body, np.roll(body, 3)])
    f = np.array([-0.07 / p.nb_fft, -0.05 / p.nb_fft], np.float32)
    cmap = get_carrier_mapper(p.nb_fft, p.nb_data_carriers)
    cbins = get_carrier_to_fft_bin(p.nb_fft, p.nb_data_carriers)
    kw = dict(nb_fft=p.nb_fft, nb_symbol_period=p.nb_symbol_period,
              nb_frame_symbols=p.nb_frame_symbols,
              nb_cyclic_prefix=p.nb_cyclic_prefix, symbol_chunk=symbol_chunk)
    bj, cj, _ = j_demod(jnp.asarray(body), jnp.asarray(f),
                        carrier_bins=jnp.asarray(cbins),
                        carrier_map=jnp.asarray(cmap), **kw)
    bt, ct, _ = t_demod(torch.as_tensor(body), torch.as_tensor(f),
                        carrier_bins=torch.as_tensor(cbins, dtype=torch.int64),
                        carrier_map=torch.as_tensor(cmap, dtype=torch.int64),
                        **kw)
    assert bt.dtype == torch.int8 and tuple(bt.shape) == tuple(bj.shape)
    assert_soft_bits_close(bt.numpy(), np.asarray(bj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-4,
                               atol=1e-6)


def test_deinterleave_matches_jax():
    rng = np.random.default_rng(9)
    nb = 1000
    hist = rng.integers(-127, 128, (3, 16, nb)).astype(np.int8)
    seq = rng.integers(-127, 128, (3, 5, nb)).astype(np.int8)
    np.testing.assert_array_equal(tdi.make_gather_index(nb),
                                  jdi.make_gather_index(nb))
    gj = jnp.asarray(jdi.make_gather_index(nb))
    gt = torch.as_tensor(tdi.make_gather_index(nb), dtype=torch.int64)
    hj, oj = jdi.deinterleave_push_block(jnp.asarray(hist), jnp.asarray(seq), gj)
    ht, ot = tdi.deinterleave_push_block(torch.as_tensor(hist),
                                         torch.as_tensor(seq), gt)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    # single pushes: the first equals JAX's, and C of them equal the block
    hj1, oj1 = jdi.deinterleave_push(jnp.asarray(hist), jnp.asarray(seq[:, 0]),
                                     gj)
    h = torch.as_tensor(hist)
    for c in range(seq.shape[1]):
        h, o = tdi.deinterleave_push(h, torch.as_tensor(seq[:, c]), gt)
        if c == 0:
            np.testing.assert_array_equal(o.numpy(), np.asarray(oj1))
        np.testing.assert_array_equal(o.numpy(), ot[:, c].numpy())
    np.testing.assert_array_equal(h.numpy(), ht.numpy())
