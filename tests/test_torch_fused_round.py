"""The fused receiver round: ``dab_radio_tpu_torch.parallel.mesh.receiver_step``
(on the CPU) against the JAX package's ``multichip_receiver_step`` on a
1x1x1 mesh, on the same numpy input.

Small mode-II ensembles (1 CIF a frame, 3 subchannels of 8 to 21 CU with
mixed UEP / EEP-A / EEP-B protection) from the JAX transmitter, with a
carrier offset and noise from the JAX channel model, quantised to u8.

Tolerances: ``fib_bits``, ``msc_bits``, ``offsets`` and the integer and
boolean carry fields are exact; the float carry fields agree to 1e-5; the
deinterleaver history (soft bits) may differ by 1 LSB on at most 5e-3 of
its values, and therefore ``fic_err`` / ``msc_err`` by at most
0.005 * 4 * nb_steps (ROADMAP F3: a carried CFO estimate one ulp apart
moves the rounding of the PLL phase). Inside the port the round is exact:
its bits and path errors are those of the port's own FICDecoder and
MSCDecoder fed the round's frames.
"""

import numpy as np
import pytest
import torch

from dab_radio_tpu.models.channel import ChannelModel
from dab_radio_tpu.models.transmitter import EnsembleTransmitter, ServiceSpec
from dab_radio_tpu.parallel.mesh import (make_receiver_mesh,
                                         multichip_receiver_step)
from dab_radio_tpu.params import SubchannelConfig as JCfg
from dab_radio_tpu_torch.convert import subchannel_config_from_jax as own
from dab_radio_tpu_torch.dab.fic import FICDecoder
from dab_radio_tpu_torch.dab.msc import MSCDecoder
from dab_radio_tpu_torch.models.demodulator import OFDMDemodulator
from dab_radio_tpu_torch.ops import viterbi as tvit
from dab_radio_tpu_torch.ops.crc import crc16_check_batch
from dab_radio_tpu_torch.parallel.mesh import (_u8_to_complex,
                                               make_timesharded_demod,
                                               receiver_step)

torch.set_num_threads(1)

MODE = 2
FS = 49152                       # samples of a mode-II frame
F = 4                            # frames a round
NB_FRAMES = 21                   # 5 rounds and the tail
LAYOUT_A = [JCfg(0, 12, False, eep_type="A", eep_prot_level=2),
            JCfg(12, 16, True, uep_table_index=0),
            JCfg(28, 21, False, eep_type="B", eep_prot_level=1)]
LAYOUT_B = [JCfg(2, 18, False, eep_type="B", eep_prot_level=2),
            # at the CIF's end: the padded per-stream gather clamps there
            JCfg(856, 8, False, eep_type="A", eep_prot_level=1),
            JCfg(30, 21, True, uep_table_index=1)]
# the second subchannel fills the CIF's last capacity units, which the
# frame's last OFDM symbol carries: what the tail is read for
LAYOUT_END = [JCfg(0, 12, False, eep_type="A", eep_prot_level=2),
              JCfg(852, 12, False, eep_type="A", eep_prot_level=2)]


def quantise_u8(iq: np.ndarray) -> np.ndarray:
    iq = iq / np.abs(iq).max() * 0.5
    pairs = np.stack([iq.real, iq.imag], -1).reshape(-1)
    return np.clip(np.round(pairs * 127.5 + 127.5), 0, 255).astype(np.uint8)


def make_capture(layout, seed, cfo_hz, lead=0):
    tx = EnsembleTransmitter(
        MODE, ensemble_id=0xC000 + seed,
        services=[ServiceSpec(0xF000 + 16 * seed + s, s, f"S{seed}{s}", cfg)
                  for s, cfg in enumerate(layout)])
    iq = tx.generate(NB_FRAMES)
    iq = ChannelModel(cfo_hz=cfo_hz, snr_db=17.0, seed=seed).apply(iq)
    return np.concatenate([np.zeros(lead, iq.dtype), iq])


@pytest.fixture(scope="module")
def captures():
    """Complex captures of two streams: layout A and layout B."""
    return [make_capture(LAYOUT_A, 1, 900.0), make_capture(LAYOUT_B, 2, -2300.0)]


@pytest.fixture(scope="module")
def mesh():
    return make_receiver_mesh(1, axis_sizes=(1, 1, 1))


def rounds_u8(caps, nb_rounds, tail=True):
    """[(blk (B, 2T), tail (B, 2*halo) or None)] of u8 rounds."""
    u8 = np.stack([quantise_u8(c) for c in caps])
    T = F * FS
    halo = OFDMDemodulator(MODE, device="cpu").window_len - FS
    out = []
    for r in range(nb_rounds):
        blk = u8[:, 2 * T * r:2 * T * (r + 1)]
        tl = u8[:, 2 * T * (r + 1):2 * T * (r + 1) + 2 * halo]
        out.append((blk, tl if tail else None))
    return out


def build_both(mesh, cfgs, B, **kw):
    """The JAX step and the port's, from one argument list."""
    per_stream = isinstance(cfgs[0], list)
    S = len(cfgs[0]) if per_stream else len(cfgs)
    tcfgs = [[own(c) for c in row] for row in cfgs] if per_stream \
        else [own(c) for c in cfgs]
    common = dict(subchannels_per_shard=S, ensembles_per_shard=B, **kw)
    jstep, jargs = multichip_receiver_step(
        mesh, MODE, F, subchannel_cfgs=cfgs, **common)
    tstep, targs = receiver_step(
        "cpu", MODE, F, subchannel_cfgs=tcfgs, **common)
    return (jstep, jargs[:2]), (tstep, targs[:2])


def assert_state_close(jstate, tstate):
    (jc, jh), (tc, th) = jstate, tstate
    for name, a, b in zip(jc._fields, jc, tc):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape == (a.shape[0], 1), name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    jh, th = np.asarray(jh).astype(np.int16), th.numpy().astype(np.int16)
    assert jh.shape == th.shape
    diff = np.abs(jh - th)
    assert diff.max() <= 1 and np.mean(diff > 0) <= 5e-3


def assert_outputs_close(jout, tout, nb_steps):
    assert sorted(jout) == sorted(tout)
    for k in ("fib_bits", "msc_bits", "offsets"):
        a, b = np.asarray(jout[k]), tout[k].numpy()
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    for k in ("fic_err", "msc_err"):
        a = np.asarray(jout[k]).astype(np.int64)
        b = tout[k].numpy().astype(np.int64)
        assert a.shape == b.shape, k
        assert np.abs(a - b).max() <= 0.005 * 4 * nb_steps, k


def run_both(both, rounds):
    """Run both steps over the rounds, comparing outputs and state after
    each; returns the port's outputs."""
    (jstep, jstate), (tstep, tstate) = both
    outs = []
    for blk, tail in rounds:
        *jstate, jout = jstep(*jstate, blk, tail)
        *tstate, tout = tstep(*tstate, blk, tail)
        nb_steps = tout["msc_bits"].shape[-1] + 6
        assert_outputs_close(jout, tout, nb_steps)
        assert_state_close(jstate, tstate)
        outs.append(tout)
    return outs


@pytest.mark.parametrize("fuse_fic", [True, False], ids=["fused", "separate"])
def test_flat_mixed_layout_matches_jax(captures, mesh, fuse_fic):
    """One mixed UEP / EEP-A / EEP-B layout shared by two streams (the same
    capture under two noise seeds): the padded depuncture with its 3-state
    mask, with the FIC folded into the decode and apart from it."""
    caps = [captures[0], ChannelModel(cfo_hz=-400.0, snr_db=20.0, seed=9)
            .apply(captures[0])]
    both = build_both(mesh, LAYOUT_A, 2, ingest="u8", fuse_fic=fuse_fic)
    tstep = both[1][0]
    assert tstep.subchannel_cfgs == [own(c) for c in LAYOUT_A]
    assert not tstep.per_stream and tstep.stop_after is None
    assert tstep.msc_nb_data_bits == both[0][0].msc_nb_data_bits
    assert tstep.tail_samples == both[0][0].tail_samples
    outs = run_both(both, rounds_u8(caps, 3))
    # the streams are locked and carry real FIBs: the CRC of a group's FIBs
    # passes on the decoded bytes
    fibs = np.packbits(outs[-1]["fib_bits"].numpy().astype(np.uint8), -1)
    assert crc16_check_batch(fibs.reshape(-1, 32)).all()


def test_per_stream_rows_match_jax(captures, mesh):
    """Two streams that monitor different ensembles: per-stream config rows,
    the clamped CIF gather and the per-stream depuncture plan."""
    both = build_both(mesh, [LAYOUT_A, LAYOUT_B], 2, ingest="u8",
                      fuse_fic=True)
    tstep = both[1][0]
    assert tstep.per_stream
    assert tstep.msc_nb_data_bits == both[0][0].msc_nb_data_bits
    assert tstep.subchannel_cfgs == [[own(c) for c in LAYOUT_A],
                                     [own(c) for c in LAYOUT_B]]
    run_both(both, rounds_u8(captures, 2))


def test_block_tracking_matches_jax(captures, mesh):
    both = build_both(mesh, LAYOUT_A, 1, ingest="u8", fuse_fic=True,
                      block_tracking=True)
    run_both(both, rounds_u8(captures[:1], 2))


@pytest.mark.parametrize("with_tail", [True, False], ids=["tail", "no_tail"])
def test_positive_fine_time_offset_matches_jax(mesh, with_tail):
    """The block starts 100 samples early, so every frame's fine-time offset
    is +100 and the last frame's body reaches into the tail: with the tail
    both packages read the stream there, without it zeros."""
    cap = make_capture(LAYOUT_END, 3, 1500.0, lead=100)
    both = build_both(mesh, LAYOUT_END, 1, ingest="u8", fuse_fic=True)
    outs = run_both(both, rounds_u8([cap], 2, tail=with_tail))
    offs = outs[-1]["offsets"].numpy()
    assert offs.shape == (1, F) and (np.abs(offs - 100) <= 2).all()


def test_tail_is_read_by_the_last_frame(mesh):
    """With a zero tail the soft bits of the last frame's last symbol
    change, and nothing else (the port alone: the tail reaches the
    demodulator, and only the last frame reads it)."""
    cap = make_capture(LAYOUT_END, 3, 1500.0, lead=100)
    tstep, (carry, hist, _) = receiver_step(
        "cpu", MODE, F, subchannels_per_shard=2, ensembles_per_shard=1,
        ingest="u8", subchannel_cfgs=[own(c) for c in LAYOUT_END],
        fuse_fic=True)
    (blk, tail), = rounds_u8([cap], 1)
    with_tail = tstep(carry, hist, blk, tail)[1].numpy()
    without = tstep(carry, hist, blk, None)[1].numpy()
    # history rows: the round's F CIFs are the newest F of the 16
    np.testing.assert_array_equal(with_tail[0, 0], without[0, 0])
    np.testing.assert_array_equal(with_tail[0, 1, :-1], without[0, 1, :-1])
    assert (with_tail[0, 1, -1] != without[0, 1, -1]).mean() > 0.05


def test_pairs_ingest_matches_jax(captures, mesh):
    """ingest="pairs": float32 (B, T, 2) in place of u8."""
    both = build_both(mesh, LAYOUT_A, 1, ingest="pairs", fuse_fic=True)
    iq = (captures[0] / np.abs(captures[0]).max() * 0.5).astype(np.complex64)
    pairs = iq.view(np.float32).reshape(1, -1, 2)
    T = F * FS
    halo = both[1][0].tail_samples
    rounds = [(pairs[:, T * r:T * (r + 1)],
               pairs[:, T * (r + 1):T * (r + 1) + halo]) for r in range(2)]
    run_both(both, rounds)
    # the port also takes the pairs as a tensor
    tstep, (carry, hist, example) = receiver_step(
        "cpu", MODE, F, subchannels_per_shard=3, ensembles_per_shard=1,
        ingest="pairs", subchannel_cfgs=[own(c) for c in LAYOUT_A])
    assert example.shape == (1, T, 2) and example.dtype == torch.float32
    a = tstep(carry, hist, rounds[0][0], rounds[0][1])[2]
    b = tstep(carry, hist, torch.from_numpy(rounds[0][0].copy()),
              torch.from_numpy(rounds[0][1].copy()))[2]
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("stop_after", ["ingest", "demod", "subs", "deint",
                                        "depunct", "acs"])
def test_stop_after_prefix_advances_state_as_the_full_step(captures, mesh,
                                                           stop_after):
    """A truncated round returns a finite digest and leaves the state where
    the full round leaves it, as far as the prefix reaches: the carry from
    "demod" on, the deinterleaver history from "deint" on. The state also
    matches the JAX step truncated at the same place."""
    (blk, tail), = rounds_u8(captures[:1], 1)
    kw = dict(ingest="u8", fuse_fic=True)
    (jstep, jstate), (tstep, tstate) = build_both(
        mesh, LAYOUT_A, 1, stop_after=stop_after, **kw)
    full, (carry0, hist0, _) = receiver_step(
        "cpu", MODE, F, subchannels_per_shard=3, ensembles_per_shard=1,
        subchannel_cfgs=[own(c) for c in LAYOUT_A], **kw)
    assert tstep.stop_after == stop_after
    carry1, hist1, _ = full(carry0, hist0, blk, tail)
    tc, th, tout = tstep(*tstate, blk, tail)
    jc, jh, jout = jstep(*jstate, blk, tail)
    assert list(tout) == ["digest"] and list(jout) == ["digest"]
    assert tout["digest"].shape == () and torch.isfinite(tout["digest"])
    want_carry = carry0 if stop_after == "ingest" else carry1
    want_hist = hist1 if stop_after in ("deint", "depunct", "acs") else hist0
    for a, b in zip(tc, want_carry):
        assert torch.equal(a, b)
    assert torch.equal(th, want_hist)
    assert_state_close((jc, jh), (tc, th))


VARIANTS = [dict(viterbi="tiled"), dict(viterbi="radix8"),
            dict(chainback="parallel"), dict(chainback="fused"),
            dict(viterbi_branch="lut")]


@pytest.mark.parametrize("kw", VARIANTS, ids=lambda kw: "-".join(kw.values()))
def test_each_decode_variant_matches_jax(captures, mesh, kw):
    """Each flag builds a round that gives the bits, path errors and offsets
    of the JAX round built with the same flag (the tiled round reports its
    errors as zeros in both)."""
    both = build_both(mesh, LAYOUT_A, 1, ingest="u8", fuse_fic=True, **kw)
    outs = run_both(both, rounds_u8(captures[:1], 2))
    if kw.get("viterbi") == "tiled":
        assert not outs[-1]["msc_err"].any() and not outs[-1]["fic_err"].any()


@pytest.mark.parametrize("kw,bad", zip(VARIANTS, [
    dict(viterbi="radix2"), dict(viterbi="radix8", chainback="fused"),
    dict(chainback="log"), dict(viterbi="radix8", chainback="fused"),
    dict(viterbi="radix8", viterbi_branch="lut")]),
    ids=["-".join(kw.values()) for kw in VARIANTS])
def test_decode_variants_that_are_not_ported_raise(kw, bad):
    """Every flag of the JAX step builds a round in the port; what is not
    ported because the JAX step has no such value or rejects the
    combination raises, as there."""
    receiver_step("cpu", MODE, F, **kw)
    with pytest.raises(ValueError, match="radix8|must be"):
        receiver_step("cpu", MODE, F, **bad)


@pytest.mark.parametrize("kw", [
    dict(viterbi="tiled", chainback="parallel"),
    dict(viterbi="tiled", chainback="fused", viterbi_branch="lut"),
    dict(viterbi="radix8", chainback="parallel"),
    dict(chainback="parallel", viterbi_branch="lut"),
    dict(viterbi="tiled", fuse_fic=False),
    dict(chainback="fused", fuse_fic=False)],
    ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_combined_decode_flags_match_jax(captures, mesh, kw):
    """Flags together, and with the FIC decoded apart: the standalone FIC
    decode takes chainback and viterbi_branch and stays exact under
    viterbi="tiled", so its path errors are real there."""
    kw = dict(dict(fuse_fic=True), **kw)
    both = build_both(mesh, LAYOUT_A, 1, ingest="u8", **kw)
    outs = run_both(both, rounds_u8(captures[:1], 1))
    if kw.get("viterbi") == "tiled":
        assert not outs[-1]["msc_err"].any()
        assert kw["fuse_fic"] or outs[-1]["fic_err"].any()


@pytest.mark.parametrize("kw", [
    dict(viterbi="tiled"), dict(viterbi="radix8"), dict(chainback="parallel"),
    dict(chainback="fused"), dict(viterbi_branch="lut")],
    ids=lambda kw: "-".join(kw.values()))
def test_exact_variants_equal_the_default_round(captures, kw):
    """Inside the port: every exact variant gives the default round's
    outputs bit for bit; the tiled round gives its bits at this SNR."""
    (blk, tail), = rounds_u8(captures[:1], 1)
    common = dict(subchannels_per_shard=3, ensembles_per_shard=1, ingest="u8",
                  subchannel_cfgs=[own(c) for c in LAYOUT_A], fuse_fic=True)
    ref, (carry, hist, _) = receiver_step("cpu", MODE, F, **common)
    var, _ = receiver_step("cpu", MODE, F, **common, **kw)
    want, got = ref(carry, hist, blk, tail)[2], var(carry, hist, blk, tail)[2]
    keys = ("fib_bits", "msc_bits", "offsets") \
        if kw.get("viterbi") == "tiled" else tuple(want)
    for k in keys:
        assert torch.equal(got[k], want[k]), k


def test_stop_after_acs_with_lut_branch(captures):
    """stop_after="acs" with viterbi_branch="lut" runs the torch forward
    pass with the LUT metrics and leaves the state as the kernel route."""
    (blk, tail), = rounds_u8(captures[:1], 1)
    common = dict(subchannels_per_shard=3, ensembles_per_shard=1, ingest="u8",
                  subchannel_cfgs=[own(c) for c in LAYOUT_A], fuse_fic=True,
                  stop_after="acs")
    a, (carry, hist, _) = receiver_step("cpu", MODE, F, **common)
    b, _ = receiver_step("cpu", MODE, F, viterbi_branch="lut", **common)
    ca, ha, oa = a(carry, hist, blk, tail)
    cb, hb, ob = b(carry, hist, blk, tail)
    assert torch.equal(ha, hb) and all(torch.equal(x, y) for x, y in zip(ca, cb))
    assert torch.isfinite(oa["digest"]) and torch.isfinite(ob["digest"])


def test_bad_arguments_raise():
    with pytest.raises(NotImplementedError, match="mode III"):
        receiver_step("cpu", 3)
    with pytest.raises(ValueError, match="stop_after"):
        receiver_step("cpu", MODE, stop_after="viterbi")
    with pytest.raises(ValueError, match="ingest"):
        receiver_step("cpu", MODE, ingest="s16")
    with pytest.raises(ValueError, match="rows"):
        receiver_step("cpu", MODE, ensembles_per_shard=3,
                      subchannel_cfgs=[[own(c) for c in LAYOUT_A]] * 2)
    with pytest.raises(ValueError, match="capacity"):
        receiver_step("cpu", MODE, subchannel_cfgs=[own(JCfg(
            860, 12, False, eep_type="A", eep_prot_level=2))])


def test_default_layout_and_initial_state():
    """Without subchannel_cfgs: subchannels_per_shard subchannels of
    nb_subchannel_cu at EEP 3-A; the carry starts at signal level 0.5."""
    tstep, (carry, hist, iq) = receiver_step(
        "cpu", MODE, 2, nb_subchannel_cu=12, subchannels_per_shard=2,
        ensembles_per_shard=3, ingest="u8")
    assert [(c.start_address, c.length, c.eep_type, c.eep_prot_level)
            for c in tstep.subchannel_cfgs] == [(0, 12, "A", 2), (12, 12, "A", 2)]
    assert iq.shape == (3, 2 * 2 * FS) and iq.dtype == torch.uint8
    assert hist.shape == (3, 2, 16, 12 * 64) and hist.dtype == torch.int8
    assert all(x.shape == (3, 1) for x in carry)
    assert torch.equal(carry.signal_l1_avg, torch.full((3, 1), 0.5))
    assert not carry.is_coarse_found.any() and not carry.total_frames.any()


def test_round_equals_the_ports_own_decoders(captures, monkeypatch):
    """Exact inside the port: the round's FIB bits, subchannel bytes and
    path errors are those of FICDecoder and MSCDecoder fed the frames that
    the round's demodulator produced, padding and lane order included."""
    errs = []
    inner = tvit.viterbi_decode

    def recording(rx_soft, spec):
        bits, err = inner(rx_soft, spec)
        errs.append(err.numpy().copy())
        return bits, err
    cfgs = [own(c) for c in LAYOUT_A]
    tstep, (carry, hist, _) = receiver_step(
        "cpu", MODE, F, subchannels_per_shard=3, ensembles_per_shard=1,
        ingest="u8", subchannel_cfgs=cfgs, fuse_fic=True)
    demod = OFDMDemodulator(MODE, device="cpu")
    demod_fn = make_timesharded_demod(demod, F)
    fic = FICDecoder(MODE, device="cpu")
    decs = [MSCDecoder(c, device="cpu") for c in cfgs]
    nb_fic = fic.dab.nb_fic_bits
    dcarry = carry
    monkeypatch.setattr(tvit, "viterbi_decode", recording)
    nb_checked = 0
    for blk, tail in rounds_u8(captures[:1], 5):
        carry, hist, out = tstep(carry, hist, blk, tail)
        dcarry, frames, _ = demod_fn(
            dcarry, _u8_to_complex(torch.from_numpy(blk.copy())),
            _u8_to_complex(torch.from_numpy(tail.copy())))
        frames = frames.numpy().reshape(F, -1)
        fib_bytes = np.packbits(out["fib_bits"].numpy().astype(np.uint8), -1)
        for f in range(F):                        # mode II: one CIF a frame
            del errs[:]
            fibs, info = fic.decode_fic(frames[f, :nb_fic])
            got = fib_bytes[0, f].reshape(-1, 32)
            assert fibs == [bytes(x[:30]) for x in got]   # all pass the CRC
            np.testing.assert_array_equal(
                out["fic_err"].numpy()[f:f + 1], info["viterbi_error"])
            for s, dec in enumerate(decs):
                del errs[:]
                ref = dec.decode_cif(frames[f, nb_fic:])
                lane = s * F + f                  # (B, S, C) lane order
                assert out["msc_err"].numpy()[lane] == errs[0][0]
                if ref is not None:
                    nb = tstep.msc_nb_data_bits[s]
                    bits = out["msc_bits"].numpy()[0, s, f, :nb]
                    assert np.packbits(bits.astype(np.uint8)).tobytes() == ref
                    nb_checked += 1
    assert nb_checked == 3 * (5 * F - 15)
