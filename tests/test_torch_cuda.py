"""Tests of the PyTorch port that need an NVIDIA GPU: the CUDA kernels
against their plain versions, and the receive chain on the card against the
same chain on the CPU. They skip without a card.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import json
import os

import numpy as np
import pytest
import torch

from dab_radio_tpu_torch.dab import fic, msc
from dab_radio_tpu_torch.host.feeder import DoubleBufferedFeeder
from dab_radio_tpu_torch.kernels import viterbi_acs as K
from dab_radio_tpu_torch.models.demodulator import (DemodCarry,
                                                    OFDMDemodulator,
                                                    StreamingDemodulator)
from dab_radio_tpu_torch.models.transmitter import (EnsembleTransmitter,
                                                    ServiceSpec)
from dab_radio_tpu_torch.parallel import dryrun
from dab_radio_tpu_torch.parallel.mesh import (ReceiverMesh,
                                               multichip_receiver_step,
                                               receiver_step)
from dab_radio_tpu_torch.params import SubchannelConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _noisy(x, rng, std):
    y = x.astype(np.float64) + rng.normal(0.0, std, x.shape)
    return np.clip(np.round(y), -127, 127).astype(np.int8)


SHAPES = [(4, 774), (72, 1542), (130, 200), (3, 9222), (5, 7), (2, 1031)]


def _symbols(B, T):
    rng = np.random.default_rng(B)
    d = rng.integers(-128, 128, (B, T, 4)).astype(np.int8)
    d[:, ::4, 3] = 0
    d[0] = 0                                   # every candidate ties
    return d


@pytest.mark.parametrize("B,T", SHAPES)
def test_viterbi_kernels_match_plain(cuda, B, T):
    d = _symbols(B, T)
    dc = torch.as_tensor(d, device=cuda)
    K.reset_launches()
    dec, err = K.viterbi_acs(dc)
    bits = K.chainback(dec)
    torch.cuda.synchronize()
    assert K.LAUNCHES == K.launched(viterbi_acs=1, viterbi_chainback=1)
    assert K.ACS_LAUNCHES_BY_T == {T: 1}
    pdec, perr = K.viterbi_acs_plain(dc)
    assert torch.equal(dec, pdec) and torch.equal(err, perr)
    assert torch.equal(bits, K.chainback_plain(pdec))
    # a (T, B)-contiguous dec, as the plain version makes it, is taken too
    assert torch.equal(K.chainback(pdec), bits)
    cbits, cerr = K.decode(torch.as_tensor(d))          # CPU: plain version
    assert torch.equal(bits.cpu(), cbits) and torch.equal(err.cpu(), cerr)


@pytest.mark.parametrize("B,T", SHAPES + [(300, 774)])
def test_fused_viterbi_kernel_matches_plain(cuda, B, T):
    d = _symbols(B, T)
    dc = torch.as_tensor(d, device=cuda)
    K.reset_launches()
    bits, err = K.decode(dc)
    torch.cuda.synchronize()
    assert K.LAUNCHES == K.launched(viterbi_decode_fused=1)
    assert K.ACS_LAUNCHES_BY_T == {T: 1}
    pdec, perr = K.viterbi_acs_plain(dc)
    assert torch.equal(err, perr)
    assert torch.equal(bits, K.chainback_plain(pdec))


@pytest.mark.parametrize("B,T", [(4, 774), (300, 320), (2, 1031),
                                 (2, K.MAX_FUSED_T + 2)])
@pytest.mark.parametrize("start,end", [(37, 22), (0, 63), (1, 0), (63, 63)])
def test_start_and_end_states_on_cuda_match_plain(cuda, B, T, start, end):
    """The best path between states other than 0 runs the kernels too, the
    fused one or the pair as the shape says, never the plain version."""
    from dab_radio_tpu_torch.ops import viterbi as vit
    dc = torch.as_tensor(_symbols(B, T), device=cuda)
    fused = T <= K.MAX_FUSED_T
    K.reset_launches()
    bits, err = vit.viterbi_decode_soft(dc, start, end)
    torch.cuda.synchronize()
    assert K.LAUNCHES == K.launched(viterbi_decode_fused=int(fused),
                                    viterbi_acs=int(not fused),
                                    viterbi_chainback=int(not fused))
    pdec, perr = K.viterbi_acs_plain(dc, start, end)
    assert torch.equal(err, perr)
    assert torch.equal(bits, K.chainback_plain(pdec, end))
    if T % 2 == 0:
        K.reset_launches()
        rbits, rerr = vit.viterbi_decode_soft_radix4(dc, start, end)
        assert K.LAUNCHES[
            "viterbi_decode_fused" if fused else "viterbi_acs"] == 1
        assert torch.equal(rbits, bits) and torch.equal(rerr, err)
    for bad in ((64, 0), (0, -1)):
        with pytest.raises(ValueError):
            K.decode(dc, *bad)


WINDOWS = [(28, 320), (936, 320), (1300, 320), (5, 32), (7, 1000), (300, 58)]


@pytest.mark.parametrize("B,L", WINDOWS)
def test_windowed_kernel_matches_plain(cuda, B, L):
    """K1's windowed mode: first tiles and interior tiles mixed, an all-tie
    window among them (every final metric equal: the anchor is state 0)."""
    rng = np.random.default_rng(L)
    dc = torch.as_tensor(_symbols(B, L), device=cuda)
    first = torch.as_tensor(rng.random(B) < 0.3, device=cuda)
    K.reset_launches()
    bits = K.decode_windows(dc, first)
    torch.cuda.synchronize()
    assert K.LAUNCHES == K.launched(viterbi_decode_windows=1)
    assert K.ACS_LAUNCHES_BY_T == {L: 1}
    assert bits.dtype == torch.int8 and tuple(bits.shape) == (B, L)
    assert torch.equal(bits, K.decode_windows_plain(dc, first))
    for flags in (torch.ones_like(first), torch.zeros_like(first)):
        assert torch.equal(K.decode_windows(dc, flags),
                           K.decode_windows_plain(dc, flags))
    cbits = K.decode_windows(dc.cpu(), first.cpu())     # CPU: plain version
    assert torch.equal(bits.cpu(), cbits)


def test_windowed_kernel_at_the_fleet_rounds_shape(cuda):
    """126,464 windows of 320 steps (9,728 lanes of 13 tiles) in one launch,
    held against the plain version on the first, some interior and the last
    1,300 windows."""
    B, L = 126464, 320
    assert K.plan(B, L) == ("fused", 16, 6976)
    rng = np.random.default_rng(6)
    dc = torch.as_tensor(rng.integers(-127, 128, (B, L, 4)).astype(np.int8),
                         device=cuda)
    first = (torch.arange(B, device=cuda) % 13) == 0
    K.reset_launches()
    bits = K.decode_windows(dc, first)
    torch.cuda.synchronize()
    assert K.LAUNCHES == K.launched(viterbi_decode_windows=1)
    for lo in (0, 61100, B - 1300):
        sl = slice(lo, lo + 1300)
        assert torch.equal(bits[sl], K.decode_windows_plain(dc[sl], first[sl]))


def test_tiled_decode_on_cuda_takes_one_windowed_launch(cuda):
    """ops/viterbi.py on a CUDA tensor: the tiled decode with the default
    flags is one windowed launch and equals the CPU's; any other flag runs
    torch on the card and launches nothing; both give the same bits."""
    from dab_radio_tpu_torch.ops import viterbi as vit
    d = _symbols(6, 1542)
    dc = torch.as_tensor(d, device=cuda)
    K.reset_launches()
    bits, none = vit.viterbi_decode_soft_tiled(dc)
    assert none is None and K.LAUNCHES == K.launched(viterbi_decode_windows=1)
    assert K.ACS_LAUNCHES_BY_T == {320: 1}
    assert torch.equal(bits.cpu(),
                       vit.viterbi_decode_soft_tiled(torch.as_tensor(d))[0])
    K.reset_launches()
    for kw in (dict(chainback="parallel"), dict(chainback="fused"),
               dict(branch="lut")):
        other, _ = vit.viterbi_decode_soft_tiled(dc, **kw)
        assert other.device.type == "cuda" and torch.equal(other, bits), kw
    want, werr = vit.viterbi_decode_soft_radix4(dc)
    assert K.LAUNCHES == K.launched(viterbi_decode_fused=1)
    for fn, kw in ((vit.viterbi_decode_soft_radix4, dict(chainback="parallel")),
                   (vit.viterbi_decode_soft_radix4, dict(chainback="fused")),
                   (vit.viterbi_decode_soft_radix4, dict(branch="lut")),
                   (vit.viterbi_decode_soft_radix8, {}),
                   (vit.viterbi_decode_soft_radix8, dict(chainback="parallel"))):
        got, gerr = fn(dc, **kw)
        assert torch.equal(got, want) and torch.equal(gerr, werr), kw
    assert K.LAUNCHES == K.launched(viterbi_decode_fused=1)


def test_windowed_wrapper_checks_cuda_inputs(cuda):
    d = torch.zeros((2, 10, 4), dtype=torch.int8, device=cuda)
    ok = torch.zeros(2, dtype=torch.bool, device=cuda)
    for bad_d in (d.to(torch.int32), d[:, :, :3],
                  torch.zeros(81, dtype=torch.int8, device=cuda)[1:]
                  .view(2, 10, 4)):
        with pytest.raises(ValueError):
            K.decode_windows(bad_d, ok)
    for bad_mask in (ok.cpu(), ok[:1], ok.to(torch.uint8), ok[:, None]):
        with pytest.raises(ValueError):
            K.decode_windows(d, bad_mask)
    empty = K.decode_windows(d[:0], ok[:0])
    assert tuple(empty.shape) == (0, 10)


def test_long_trellis_takes_the_kernel_pair(cuda):
    T = K.MAX_FUSED_T + 1
    dc = torch.as_tensor(_symbols(2, T), device=cuda)
    K.reset_launches()
    bits, err = K.decode(dc)
    torch.cuda.synchronize()
    assert K.LAUNCHES == K.launched(viterbi_acs=1, viterbi_chainback=1)
    with pytest.raises(ValueError):
        K.decode_fused(dc)
    with pytest.raises(ValueError, match="shared memory"):   # no windowed pair
        K.decode_windows(dc, torch.ones(2, dtype=torch.bool, device=cuda))
    short = dc[:, :K.MAX_FUSED_T].contiguous()          # the last T that fits
    fbits, ferr = K.decode_fused(short)
    dec, perr = K.viterbi_acs(short)
    assert torch.equal(ferr, perr) and torch.equal(fbits, K.chainback(dec))


def test_viterbi_wrappers_check_cuda_inputs(cuda):
    with pytest.raises(ValueError):
        K.viterbi_acs(torch.zeros((2, 10, 4), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        K.viterbi_acs(torch.zeros((2, 10, 3), dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError):                    # not 4-byte aligned
        K.viterbi_acs(torch.zeros(81, dtype=torch.int8,
                                  device=cuda)[1:].view(2, 10, 4))
    with pytest.raises(ValueError):
        K.chainback(torch.zeros((10, 2), dtype=torch.int32, device=cuda))
    for bad in (torch.zeros((2, 10, 4), dtype=torch.int32, device=cuda),
                torch.zeros((2, 10, 3), dtype=torch.int8, device=cuda),
                torch.zeros((2, 10, 8), dtype=torch.int8, device=cuda)[:, :, :4],
                torch.zeros(81, dtype=torch.int8, device=cuda)[1:].view(2, 10, 4)):
        with pytest.raises(ValueError):
            K.decode(bad)
        with pytest.raises(ValueError):
            K.decode_fused(bad)
    bits, err = K.decode(torch.zeros((0, 10, 4), dtype=torch.int8, device=cuda))
    assert bits.shape == (0, 10) and err.shape == (0,)


def test_fic_and_msc_decode_on_cuda_match_cpu(cuda):
    rng = np.random.default_rng(1)
    payloads = [bytes(rng.integers(0, 256, 20).astype(np.uint8))
                for _ in range(12)]
    soft = _noisy(fic.FICEncoder(1).encode_fic(payloads), rng, 60.0)
    got = fic.FICDecoder(1, cuda).decode_fic(soft)
    ref = fic.FICDecoder(1, device="cpu").decode_fic(soft)
    assert got[0] == ref[0] and got[1]["crc_errors"] == ref[1]["crc_errors"]
    np.testing.assert_array_equal(got[1]["viterbi_error"],
                                  ref[1]["viterbi_error"])
    cfgs = [SubchannelConfig(0, 12, False, eep_type="A", eep_prot_level=2),
            SubchannelConfig(12, 12, False, eep_type="A", eep_prot_level=2)]
    encs = [msc.MSCEncoder(c) for c in cfgs]
    dg = [msc.MSCDecoder(c, cuda) for c in cfgs]
    dc = [msc.MSCDecoder(c, device="cpu") for c in cfgs]
    for _ in range(6):
        cifs = np.zeros((4, 864 * 64), np.int8)
        for k in range(4):
            for c, e in zip(cfgs, encs):
                pay = rng.integers(0, 256, e.nb_data_bytes).astype(np.uint8)
                a = e.encode_cif(pay.tobytes())
                cifs[k, c.start_address * 64:
                     c.start_address * 64 + a.shape[0]] = a
        cifs = _noisy(cifs, rng, 40.0)
        assert msc.decode_frame_group(dg, cifs) == \
            msc.decode_frame_group(dc, cifs)
    assert dg[0].history.device.type == "cuda"


def test_receive_chain_on_cuda_matches_cpu(cuda):
    tx = EnsembleTransmitter(1, services=[ServiceSpec(
        0xF123, 3, "Radio", SubchannelConfig(0, 12, False, eep_type="A",
                                             eep_prot_level=2))], device=cuda)
    iq = np.concatenate([np.zeros(7000, np.complex64), tx.generate(4),
                         np.zeros(7000, np.complex64)])
    rng = np.random.default_rng(2)
    n = np.arange(iq.shape[0])
    noise = rng.normal(size=(2, iq.shape[0])) * np.abs(iq).std() * 0.07
    iq = (iq * np.exp(2j * np.pi * 2.4 / 2048 * n) + noise[0] + 1j * noise[1]
          ).astype(np.complex64)
    sdg = StreamingDemodulator(OFDMDemodulator(1, device=cuda))
    sdc = StreamingDemodulator(OFDMDemodulator(1, device="cpu"))
    fg, fc = sdg.process(iq), sdc.process(iq)
    assert len(fg) == len(fc) >= 3
    assert int(sdg.carry.total_desync) == int(sdc.carry.total_desync) == 0
    # cuFFT and the CPU FFT round differently: the carried CFO differs by
    # ulps, which the float32 PLL phase turns into 1-LSB soft-bit changes.
    # The noise spreads the soft values; on a noise-free signal they bunch
    # at one magnitude per symbol and flip together.
    diff = np.abs(np.stack(fg).astype(np.int16) - np.stack(fc))
    assert diff.max() <= 1 and (diff != 0).mean() <= 5e-3


def test_fused_kernel_at_the_fleet_rounds_shape(cuda):
    """K1 at 9728 messages of 1542 steps (16 streams x 8 frames of the
    18-service ensemble): 12 messages a block, 811 blocks, several waves.
    The plain version cannot hold that shape's branch metrics at once, so
    it runs on 1216 messages at a time (messages are independent)."""
    B, T = 9728, 1542
    assert K.plan(B, T) == ("fused", 12, 17984)
    dc = torch.as_tensor(_symbols(B, T), device=cuda)
    K.reset_launches()
    bits, err = K.decode(dc)
    torch.cuda.synchronize()
    assert K.LAUNCHES["viterbi_decode_fused"] == 1
    assert K.ACS_LAUNCHES_BY_T == {T: 1}
    for lo in range(0, B, 1216):
        pdec, perr = K.viterbi_acs_plain(dc[lo:lo + 1216])
        assert torch.equal(err[lo:lo + 1216], perr)
        assert torch.equal(bits[lo:lo + 1216], K.chainback_plain(pdec))


def test_fused_round_on_cuda_matches_cpu(cuda):
    """The round's step on the card against the step on the CPU, on a
    mode-II capture from the port's transmitter with a carrier offset and
    noise: decoded bits and offsets exact, one fused launch a round; the
    soft-bit history within the cuFFT tolerance of the test above."""
    cfgs = [SubchannelConfig(0, 12, False, eep_type="A", eep_prot_level=2),
            SubchannelConfig(12, 16, True, uep_table_index=0),
            SubchannelConfig(852, 12, False, eep_type="A", eep_prot_level=2)]
    tx = EnsembleTransmitter(2, services=[
        ServiceSpec(0xF100 + i, i + 1, f"S{i}", c)
        for i, c in enumerate(cfgs)], device=cuda)
    F, fs = 4, 49152
    iq = tx.generate(2 * F + 1)
    rng = np.random.default_rng(4)
    n = np.arange(iq.shape[0])
    noise = rng.normal(size=(2, iq.shape[0])) * np.abs(iq).std() * 0.07
    iq = iq * np.exp(2j * np.pi * 0.3 / 512 * n) + noise[0] + 1j * noise[1]
    iq = (iq / np.abs(iq).max() * 0.5).astype(np.complex64)
    u8 = np.clip(np.round(iq.view(np.float32) * 127.5 + 127.5), 0, 255
                 ).astype(np.uint8)
    u8 = np.stack([u8, np.roll(u8, 2 * F * fs)])     # 4 frames apart
    steps = {}
    for dev in (cuda, torch.device("cpu")):
        steps[dev.type] = receiver_step(
            dev, 2, F, subchannels_per_shard=3, ensembles_per_shard=2,
            ingest="u8", subchannel_cfgs=cfgs, fuse_fic=True)
    (gstep, gstate), (cstep, cstate) = steps["cuda"], steps["cpu"]
    gstate, cstate = gstate[:2], cstate[:2]
    halo = gstep.tail_samples
    for r in range(2):
        blk = u8[:, 2 * F * fs * r:2 * F * fs * (r + 1)]
        tail = u8[:, 2 * F * fs * (r + 1):2 * F * fs * (r + 1) + 2 * halo]
        K.reset_launches()
        *gstate, gout = gstep(*gstate, blk, tail)
        torch.cuda.synchronize()
        assert K.LAUNCHES == K.launched(viterbi_decode_fused=1)
        *cstate, cout = cstep(*cstate, blk, tail)
        for k in ("fib_bits", "msc_bits", "offsets"):
            assert gout[k].device.type == "cuda"
            assert torch.equal(gout[k].cpu(), cout[k]), k
        nb_steps = cout["msc_bits"].shape[-1] + 6
        for k in ("fic_err", "msc_err"):
            d = (gout[k].cpu().long() - cout[k].long()).abs().max()
            assert d <= 0.005 * 4 * nb_steps, k
        diff = (gstate[1].cpu().to(torch.int16) - cstate[1]).abs()
        assert diff.max() <= 1 and (diff != 0).float().mean() <= 5e-3


def test_feeder_stages_through_pinned_memory(cuda):
    """On a CUDA device the feeder hands out device tensors whose copies
    the consumer's stream has been made to wait for; its host buffers are
    pinned and reused."""
    rng = np.random.default_rng(5)
    rounds = [(rng.integers(0, 256, (4, 4096)).astype(np.uint8),
               rng.integers(0, 256, (4, 64)).astype(np.uint8) if r % 3 else None)
              for r in range(12)]
    it = iter(rounds)
    with DoubleBufferedFeeder(lambda: next(it, None), depth=2,
                              device=cuda) as f:
        slots = f._stage.slots
        got = [(blk.clone(), None if tail is None else tail.clone(),
                blk.device.type) for blk, tail in f]
        assert f.get(timeout=5.0) is None
    torch.cuda.synchronize()
    assert len(got) == 12 and len(slots) == 3
    assert all(s[0].is_pinned() for s in slots)
    for (blk, tail, where), (rblk, rtail) in zip(got, rounds):
        assert where == "cuda"
        np.testing.assert_array_equal(blk.cpu().numpy(), rblk)
        assert (tail is None) == (rtail is None)
        if tail is not None:
            np.testing.assert_array_equal(tail.cpu().numpy(), rtail)
    assert f.stats.rounds == 12 and not f._thread.is_alive()


def test_mesh_step_on_cuda_launches_k1_once(cuda):
    """The mesh step of the one-rank mesh on the card is receiver_step's
    round: the same outputs, and its decode is one fused K1 launch."""
    cfgs = [SubchannelConfig(0, 12, False, eep_type="A", eep_prot_level=2),
            SubchannelConfig(12, 16, True, uep_table_index=0)]
    kw = dict(subchannels_per_shard=2, ensembles_per_shard=2, ingest="u8",
              subchannel_cfgs=cfgs, fuse_fic=True)
    one, (c1, h1, _) = receiver_step(cuda, 2, 2, **kw)
    many, (c2, h2, _) = multichip_receiver_step(ReceiverMesh((1, 1, 1)), 2,
                                                2, device=cuda, **kw)
    rng = np.random.default_rng(6)
    blk = torch.as_tensor(rng.integers(0, 256, (2, 4 * 49152)), device=cuda
                          ).to(torch.uint8)
    K.reset_launches()
    o2 = many(c2, h2, blk)[2]
    torch.cuda.synchronize()
    assert K.LAUNCHES == K.launched(viterbi_decode_fused=1)
    o1 = one(c1, h1, blk)[2]
    assert all(torch.equal(o1[k], o2[k]) for k in o1)


def test_mesh_dryrun_ranks_share_the_card_over_gloo(cuda, tmp_path):
    """Two rank processes on the one card, (1, 1, 2) over gloo: the dry run
    is bit-exact, each rank's decode is K1 (FIC and MSC, two fused
    launches), and the collectives copy the CUDA tensors through the
    host."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    init = f"file://{tmp_path}/rdzv"
    outs = dryrun.launch([dryrun.rank_command(r, 2, init, (1, 1, 2), "cuda",
                                              "gloo") for r in range(2)],
                         300, cwd=root, env=dict(os.environ, PYTHONPATH=root))
    assert [rc for rc, _ in outs] == [0, 0], outs
    line, = [ln for ln in outs[0][1].splitlines() if ln.startswith("dryrun: ")]
    report = json.loads(line[len("dryrun: "):])
    assert report["bit_exact"] and report["backend"] == "gloo"
    for r in report["ranks"]:
        assert r["launches"] == K.launched(viterbi_decode_fused=2)
        assert r["collectives"]["host_copies"] > 0 and not r["loaded_jax"]


# ---- captured CUDA graphs (utils/graphs.py) --------------------------------

GRAPH_CFGS = [SubchannelConfig(0, 12, False, eep_type="A", eep_prot_level=2),
              SubchannelConfig(12, 16, True, uep_table_index=0)]


def _graph_rounds(cuda, F=2, nb_rounds=4):
    """nb_rounds u8 rounds of 2 mode-II streams of F frames from the port's
    transmitter, with a carrier offset and noise; the last two without a
    tail (the key of their own is captured and replayed)."""
    tx = EnsembleTransmitter(2, services=[
        ServiceSpec(0xF100 + i, i + 1, f"S{i}", c)
        for i, c in enumerate(GRAPH_CFGS)], device=cuda)
    fs = 49152
    iq = tx.generate(nb_rounds * F + 2)
    rng = np.random.default_rng(8)
    n = np.arange(iq.shape[0])
    noise = rng.normal(size=(2, iq.shape[0])) * np.abs(iq).std() * 0.07
    iq = iq * np.exp(2j * np.pi * 0.3 / 512 * n) + noise[0] + 1j * noise[1]
    iq = (iq / np.abs(iq).max() * 0.5).astype(np.complex64)
    u8 = np.clip(np.round(iq.view(np.float32) * 127.5 + 127.5), 0, 255
                 ).astype(np.uint8)
    u8 = np.stack([u8, np.roll(u8, 2 * fs)])
    halo = OFDMDemodulator(2, device=cuda).window_len - fs
    n = 2 * F * fs
    return [(u8[:, n * r:n * (r + 1)],
             u8[:, n * (r + 1):n * (r + 1) + 2 * halo]
             if r < nb_rounds - 2 else None) for r in range(nb_rounds)]


def _cloned(x):
    return [t.clone() if torch.is_tensor(t) else t
            for t in torch.utils._pytree.tree_leaves(x)]


@pytest.mark.parametrize("kw", [
    dict(), dict(viterbi="tiled"), dict(block_tracking=True),
    dict(fuse_fic=False), dict(chainback="parallel"), dict(chainback="fused"),
    dict(viterbi_branch="lut"), dict(viterbi="radix8"),
    dict(stop_after="deint"), dict(stop_after="acs")],
    ids=lambda kw: "-".join(map(str, kw.values())) or "exact")
def test_captured_round_matches_eager(cuda, kw):
    """receiver_step captured (the default on the card) against
    cuda_graph=False over 4 rounds, two of them without a tail: every
    output and the state bit-identical, and K1's launches counted once a
    round on replays as in the eager run."""
    args = dict(subchannels_per_shard=2, ensembles_per_shard=2, ingest="u8",
                subchannel_cfgs=GRAPH_CFGS, fuse_fic=True)
    args.update(kw)
    graph, (gc, gh, _) = receiver_step(cuda, 2, 2, **args)
    eager, (ec, eh, _) = receiver_step(cuda, 2, 2, cuda_graph=False, **args)
    assert graph.captured and graph.tail_samples == eager.tail_samples
    gstate, estate = (gc, gh), (ec, eh)
    for blk, tail in _graph_rounds(cuda):
        K.reset_launches()
        *estate, eout = eager(*estate, blk, tail)
        torch.cuda.synchronize()
        want_launches = dict(K.LAUNCHES), dict(K.ACS_LAUNCHES_BY_T)
        K.reset_launches()
        *gstate, gout = graph(*gstate, blk, tail)
        torch.cuda.synchronize()
        assert (dict(K.LAUNCHES), dict(K.ACS_LAUNCHES_BY_T)) == want_launches
        # the captured state goes back in as it came out: the program
        # copies it into its inputs before the next replay
        for a, b in zip(_cloned((gstate, gout)), _cloned((estate, eout))):
            assert (a is None and b is None) or torch.equal(a, b)
    assert graph.graphs == 2


def test_captured_demod_matches_eager(cuda):
    """frame_step, frame_step_batch and frame_scan captured (the default on
    the card) against cuda_graph=False, three calls each, each call's carry
    fed to the next: bit-identical, and the results are copies (a kept
    carry survives the next call)."""
    graph = OFDMDemodulator(2, device=cuda)
    eager = OFDMDemodulator(2, device=cuda, cuda_graph=False)
    assert graph._step_program.captured and not eager._step_program.captured
    blk, _ = _graph_rounds(cuda, F=4, nb_rounds=3)[0]
    iq = (blk.astype(np.float32) - 127.5) / np.float32(127.5)
    iq = iq.view(np.complex64)
    W, A = graph.window_len, graph.frame_advance
    for batch in ((), (2,)):
        rows = iq if batch else iq[0]
        carry = {d: DemodCarry.init(batch, device=cuda) for d in ("g", "e")}
        kept = []
        for f in range(3):
            win = rows[..., f * A:f * A + W]
            gc, gout = graph.frame_step_batch(carry["g"], win) if batch \
                else graph.frame_step(carry["g"], win)
            ec, eout = eager._frame_step_impl(carry["e"], eager._as_iq(win))
            for a, b in zip(_cloned((gc, gout)), _cloned((ec, eout))):
                assert torch.equal(a, b)
            kept.append((gc, _cloned(gc)))
            carry = {"g": gc, "e": ec}
        for held, copy in kept:
            assert all(torch.equal(a, b) for a, b in zip(held, copy))
        for nb in (2, 3):
            buf = rows[..., :nb * A + W]
            c0 = DemodCarry.init(batch, device=cuda)
            for _ in range(2):
                got = graph.frame_scan(nb, c0, buf)
                want = eager.frame_scan(nb, c0, buf)
                for a, b in zip(_cloned(got), _cloned(want)):
                    assert torch.equal(a, b)
    assert graph._step_program.graphs == 2 and graph._scan_program.graphs == 4


def test_captured_fused_fleet_matches_eager(cuda):
    """FusedFleet with its round captured (the default on the card) against
    cuda_graph=False, deferred fetch: the same FIB and subchannel bytes and
    health signals each round, one fused K1 launch a round counted across
    the replays, and the state read back equal."""
    from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
    fleets = {g: FusedFleet(2, GRAPH_CFGS, 2, 2, device=cuda, cuda_graph=g)
              for g in (None, False)}
    assert fleets[None].program.captured
    assert not fleets[False].program.captured
    seen = {g: [] for g in fleets}
    for g, fleet in fleets.items():
        fleet._consume = lambda fib, msc, g=g: seen[g].append(
            (fib.copy(), msc.copy()))
    rounds = _graph_rounds(cuda)
    for g, fleet in fleets.items():
        K.reset_launches()
        for blk, tail in rounds:
            fleet.process_round(blk, defer_fetch=True, tail_u8=tail)
        fleet.flush()
        torch.cuda.synchronize()
        assert K.LAUNCHES == K.launched(viterbi_decode_fused=len(rounds))
    assert len(seen[None]) == len(rounds)
    for (f1, m1), (f2, m2) in zip(seen[None], seen[False]):
        assert np.array_equal(f1, f2) and np.array_equal(m1, m2)
    (ca, ha), (cb, hb) = fleets[None].state(), fleets[False].state()
    assert all(np.array_equal(x, y) for x, y in zip(ca, cb))
    assert np.array_equal(ha, hb)
    assert fleets[None].program.graphs == 2


def test_released_program_captures_again(cuda):
    """release() frees the graphs and their pool; the next call of a shape
    warms up and captures again, with the same outputs as before."""
    args = dict(subchannels_per_shard=2, ensembles_per_shard=2, ingest="u8",
                subchannel_cfgs=GRAPH_CFGS, fuse_fic=True)
    graph, (c, h, _) = receiver_step(cuda, 2, 2, **args)
    blk, tail = _graph_rounds(cuda)[0]
    first = _cloned(graph(c, h, blk, tail))
    again = _cloned(graph(c, h, blk, tail))            # a replay
    graph.release()
    assert graph.graphs == 0
    K.reset_launches()
    after = _cloned(graph(c, h, blk, tail))            # warm-up, capture
    replay = _cloned(graph(c, h, blk, tail))
    torch.cuda.synchronize()
    assert graph.graphs == 1
    assert K.LAUNCHES == K.launched(viterbi_decode_fused=2)
    for x in (again, after, replay):
        assert all(torch.equal(a, b) for a, b in zip(first, x))


def _tx_frames(cuda, nb_services=12, nb_frames=8, seed=3):
    """Noisy soft-bit frames of a mode-I ensemble of nb_services EEP 3-A
    services (the FIC names some only in the second frame) and one UEP
    service, from the port's transmitter."""
    cfgs = [SubchannelConfig(12 * i, 12, False, eep_type="A",
                             eep_prot_level=2) for i in range(nb_services)]
    cfgs.append(SubchannelConfig(12 * nb_services, 21, True,
                                 uep_table_index=1))
    tx = EnsembleTransmitter(1, services=[
        ServiceSpec(0xA300 + i, i + 1, f"S{i}", c)
        for i, c in enumerate(cfgs)], device=cuda)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nb_frames):
        soft = tx.next_frame_bits().astype(np.float64)
        soft += rng.normal(0.0, 40.0, soft.shape)
        out.append(np.clip(np.round(soft), -127, 127).astype(np.int8))
    return out


def _tapped(rx, log):
    inner = rx.fic.decode_fic

    def decode_fic(bits):
        fibs, err = inner(bits)
        log.append(("fic", fibs))
        return fibs, err
    rx.fic.decode_fic = decode_fic
    rx.on_audio_channel.append(lambda sub_id, ch: ch.events.on_frame_data
                               .append(lambda p: log.append((sub_id, p))))
    return rx


@pytest.mark.parametrize("mode", ["exact", "tiled"])
def test_captured_receiver_decodes_match_eager(cuda, mode):
    """DabReceiver with its FIC decode and persistent decode groups
    captured (the default on the card) against cuda_graph=False on the same
    frames: the same FIBs and MSC payloads in the same order, the same K1
    launches, the histories equal; the group of 12 captured once."""
    from dab_radio_tpu_torch.models.receiver import DabReceiver
    frames = _tx_frames(cuda)
    logs, launches, rxs = {}, {}, {}
    try:
        msc.set_decode_mode(mode)
        for g in (None, False):
            rx = _tapped(DabReceiver(1, device=cuda, cuda_graph=g),
                         logs.setdefault(g, []))
            K.reset_launches()
            for f in frames:
                rx.process_frame(f)
            torch.cuda.synchronize()
            launches[g], rxs[g] = dict(K.LAUNCHES), rx
    finally:
        msc.set_decode_mode("exact")
    assert logs[None] == logs[False] and len(logs[None]) > 100
    assert launches[None] == launches[False]
    (group,) = rxs[None]._groups.values()
    assert group.program.captured and group.program.graphs == 1
    assert rxs[None].fic._program.graphs == 1
    for sub_id, ch in rxs[None].channels.items():
        assert torch.equal(ch.msc.history,
                           rxs[False].channels[sub_id].msc.history)


def test_captured_msc_decoder_and_fleet_match_eager(cuda):
    """MSCDecoder's decode_cif and decode_frame, and ReceiverFleet (its
    stacked FIC decode and groups across receivers, pipelined), captured
    against cuda_graph=False: bit-identical payloads and access order."""
    from dab_radio_tpu_torch.models.fleet import ReceiverFleet
    from dab_radio_tpu_torch.models.receiver import DabReceiver
    frames = _tx_frames(cuda, nb_services=4, nb_frames=10)
    other = _tx_frames(cuda, nb_services=4, nb_frames=10, seed=4)
    cfg = SubchannelConfig(12, 12, False, eep_type="A", eep_prot_level=2)
    decs = {g: msc.MSCDecoder(cfg, cuda, g) for g in (None, False)}
    split = DabReceiver(1, device=cuda).split_frame
    cifs = [split(f)[1] for f in frames]
    for c in cifs:
        assert decs[None].decode_frame(c) == decs[False].decode_frame(c)
        for row in c:
            assert decs[None].decode_cif(row) == decs[False].decode_cif(row)
    assert decs[None]._program.graphs == 2
    logs = {}
    for g in (None, False):
        fleet = ReceiverFleet(2, 1, pipeline_depth=1, device=cuda,
                              cuda_graph=g)
        for rx in fleet.receivers:
            _tapped(rx, logs.setdefault(g, []))
        for f, o in zip(frames, other):
            fleet.process_frames([(0, f), (1, o)])
        fleet.flush()
    assert logs[None] == logs[False] and len(logs[None]) > 20


@pytest.mark.parametrize("K_", [1, 2])
def test_captured_multistream_round_matches_eager(cuda, K_):
    """MultiStreamDemodulator's round (dequantise, step or scan, masked
    merge) captured against cuda_graph=False: the same frames, bits kept on
    the card equal, the carry equal."""
    from dab_radio_tpu_torch.models.multistream import MultiStreamDemodulator
    blk, _ = _graph_rounds(cuda, F=4, nb_rounds=3)[0]
    runs = {}
    for g in (None, False):
        ms = MultiStreamDemodulator(OFDMDemodulator(2, device=cuda), 2,
                                    frames_per_step=K_, ingest="u8",
                                    fetch_bits=False, device=cuda,
                                    cuda_graph=g)
        assert ms.program.captured == (g is None)
        got = []
        for lo in range(0, blk.shape[1], 60000):
            for i in range(2):
                ms.push(i, blk[i, lo:lo + 60000])
            got += ms.step()
        runs[g] = ([(i, b.cpu()) for i, b in got], ms.carry)
    (a, ca), (b, cb) = runs[None], runs[False]
    assert [i for i, _ in a] == [i for i, _ in b] and len(a) >= 4
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(ca, cb))


def test_captured_acquire_and_modulator_match_eager(cuda):
    """acquire and l1 (keyed by block shape) and the modulator's two entries
    captured against cuda_graph=False: bit-identical, results kept across
    calls."""
    from dab_radio_tpu_torch.models.modulator import OFDMModulator
    graph = OFDMDemodulator(2, device=cuda)
    eager = OFDMDemodulator(2, device=cuda, cuda_graph=False)
    blk, _ = _graph_rounds(cuda, F=2, nb_rounds=3)[0]
    iq = ((blk[0].astype(np.float32) - 127.5) / np.float32(127.5)
          ).view(np.complex64)
    W = graph.window_len
    for lo in range(0, iq.shape[0] - W, W // 3):
        win = iq[lo:lo + W]
        l1g, l1e = graph.l1(win), eager.l1(win)
        assert torch.equal(l1g, l1e)
        for a, b in zip(graph.acquire(win, l1g), eager.acquire(win, l1e)):
            assert torch.equal(a, b)
    assert graph._acquire_program.graphs == 1
    mods = {g: OFDMModulator(1, cuda, cuda_graph=g) for g in (None, False)}
    p = mods[None].params
    rng = np.random.default_rng(9)
    kept = []
    for _ in range(3):
        bits = rng.integers(0, 2, (p.nb_data_symbols,
                                   2 * p.nb_data_carriers)).astype(np.uint8)
        data = rng.integers(0, 256, p.nb_data_symbols * p.nb_data_carriers
                            // 4).astype(np.uint8)
        got = mods[None].modulate_frame(bits)
        assert torch.equal(got, mods[False].modulate_frame(bits))
        kept.append((got, got.clone()))
        assert np.array_equal(mods[None].modulate_reference_bytes(data),
                              mods[False].modulate_reference_bytes(data))
    assert all(torch.equal(a, b) for a, b in kept)
    assert mods[None]._bits_program.graphs == 1
