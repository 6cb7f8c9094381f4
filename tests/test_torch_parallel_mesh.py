"""The mesh version of the round, over ranks of a gloo process group on the
CPU: ``dab_radio_tpu_torch.parallel.mesh`` against the JAX package's
``parallel/mesh.py`` on a mesh of the same axis sizes (the 8 virtual CPU
devices of tests/conftest.py), from one numpy seed.

The ranks are processes (``python -c RANK_SCRIPT``, which imports the port
alone), started together with a file rendezvous in tmp_path; the inputs go
to them and their gathered results come back as pickled numpy arrays. The
JAX reference is computed in the test process while they run. One launch of
two ranks runs every case of this file; each test reads one case.

Tolerances (ROADMAP F3): offsets, sync flags, FIB and MSC bits and the
integer carry are exact; float carry fields agree to 1e-5; soft bits (the
demod's frames, the deinterleaver history) may differ by 1 LSB on at most
5e-3 of their values, so path errors by at most 0.005 * 4 * nb_steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dab_radio_tpu.models.demodulator import (DemodCarry as JCarry,
                                              OFDMDemodulator as JDemod)
from dab_radio_tpu.ops.iq import iq_pairs
from dab_radio_tpu.parallel import mesh as jmesh
from dab_radio_tpu_torch.convert import subchannel_config_from_jax as own
from dab_radio_tpu_torch.parallel import distributed
from dab_radio_tpu_torch.parallel import mesh as tmesh
from torch_ranks import (F_LOC, FS, HALO, LAYOUT, MODE, STEP_FLAGS,
                         assert_carry_close, assert_round_close,
                         assert_soft_close, capture, jmesh_of, quantise_u8,
                         run_dryrun, run_ranks, step_cases, step_reference,
                         u8_rounds)

# ---- the cases of the two-rank launch ----------------------------------------

DEMOD_AXES = (1, 2, 1)
STEP_AXES = (1, 1, 2)


def demod_cases(caps):
    """(1, 2, 1): the aligned block with its tail, the block 120 samples
    early (every frame at offset +120, the last one reading into the tail)
    with and without the tail, and block tracking."""
    T = DEMOD_AXES[1] * F_LOC * FS
    early = np.stack([np.concatenate([np.zeros(120, np.complex64), c])
                      for c in caps])
    cases = {}
    for name, src, tail, bt in (("aligned", caps, True, False),
                                ("early_tail", early, True, False),
                                ("early_no_tail", early, False, False),
                                ("block_tracking", caps, True, True)):
        src = np.stack(src)
        cases[f"demod_{name}"] = dict(
            kind="demod", axes=DEMOD_AXES, f_loc=F_LOC, block_tracking=bt,
            iq=src[:, :T], tail=src[:, T:T + HALO] if tail else None)
    return cases


def demod_reference(case):
    mesh = jmesh_of(case["axes"])
    B, n_time = case["iq"].shape[0], case["axes"][1]
    fn = jmesh.make_timesharded_demod(JDemod(MODE), mesh, case["f_loc"],
                                      block_tracking=case["block_tracking"])
    carry = JCarry.init((B, n_time))._replace(
        signal_l1_avg=jnp.full((B, n_time), 0.5, jnp.float32))
    iq = jax.device_put(jnp.asarray(iq_pairs(case["iq"])),
                        NamedSharding(mesh, P("ens", "time")))
    tail = None if case["tail"] is None else jnp.asarray(
        iq_pairs(case["tail"]))
    carry, bits, offs = fn(carry, iq, tail)
    return [np.asarray(x) for x in carry], np.asarray(bits), np.asarray(offs)


COLD_F_LOC = 3


def coldstart_case():
    """Two streams that start at a random frame phase after a stretch of
    weak noise, over (1, 2, 1), from a cold carry."""
    rng = np.random.default_rng(7)
    T = DEMOD_AXES[1] * COLD_F_LOC * FS
    rows = []
    for b in range(2):
        lead = int(rng.integers(FS // 4, FS))
        iq = capture(20 + b, T // FS + 1, 300.0 * (b + 1))
        noise = (rng.normal(0, 0.01, lead)
                 + 1j * rng.normal(0, 0.01, lead)).astype(np.complex64)
        rows.append(np.concatenate([noise, iq])[:T])
    return dict(kind="coldstart", axes=DEMOD_AXES, f_loc=COLD_F_LOC,
                iq=np.stack(rows))


def coldstart_reference(case):
    mesh = jmesh_of(case["axes"])
    fn = jmesh.make_coldstart_timesharded_demod(JDemod(MODE), mesh,
                                                case["f_loc"])
    carry, bits, valid = fn(jax.device_put(
        jnp.asarray(iq_pairs(case["iq"])),
        NamedSharding(mesh, P("ens", "time"))))
    return [np.asarray(x) for x in carry], np.asarray(bits), np.asarray(valid)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every case of this file in one launch of two ranks; returns
    (cases, JAX references, the ranks' results)."""
    caps = [capture(1, 9, 900.0), capture(2, 9, -2300.0)]
    cases = demod_cases(caps)
    cases["coldstart"] = coldstart_case()
    cases.update(step_cases(quantise_u8(np.stack(caps)), STEP_AXES))
    refs = {"demod": demod_reference, "coldstart": coldstart_reference,
            "step": step_reference}
    ref, res = run_ranks(tmp_path_factory.mktemp("two_ranks"), 2, cases,
                         lambda: {name: refs[c["kind"]](c)
                                  for name, c in cases.items()})
    return cases, ref, res


# ---- tests -------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 17))
def test_factoring_policy_is_jax(n):
    """n ranks factor as n JAX devices do: a factor of 2 to 'sub' and one
    to 'time' when there is one, the rest to 'ens'."""
    want = dict(jmesh.make_receiver_mesh(n).shape) if n <= 8 else None
    got = tmesh.mesh_axis_sizes(n)
    expect = {1: (1, 1, 1), 2: (1, 1, 2), 3: (3, 1, 1), 4: (1, 2, 2),
              6: (3, 1, 2), 8: (2, 2, 2), 12: (3, 2, 2), 16: (4, 2, 2)}
    if n in expect:
        assert got == expect[n]
    if n % 2:
        assert got == (n, 1, 1)
    if want is not None:
        assert got == (want["ens"], want["time"], want["sub"])
    assert int(np.prod(got)) == n


def test_one_rank_mesh_without_a_process_group():
    """Without a process group: initialize() is False, the mesh is the
    one-rank mesh with no groups, a larger one is refused, and the
    collectives are the identity."""
    assert distributed.initialize() is False
    assert distributed.initialize(world_size=1) is False
    mesh = distributed.global_receiver_mesh()
    assert mesh.axis_sizes == (1, 1, 1) and mesh.groups is None
    assert mesh.is_leader and mesh.coords == {"ens": 0, "time": 0, "sub": 0}
    with pytest.raises(ValueError, match="process group"):
        tmesh.make_receiver_mesh(2)
    with pytest.raises(ValueError, match="factor"):
        tmesh.make_receiver_mesh(1, axis_sizes=(1, 2, 1))
    x = torch.arange(6).reshape(2, 3)
    assert torch.equal(tmesh._all_gather(mesh, "time", x), x[None])
    head, tail = torch.ones(2, 4, dtype=torch.complex64), torch.zeros(
        2, 4, dtype=torch.complex64)
    assert tmesh._halo_from_right(mesh, head, tail) is tail
    iq, row0 = distributed.host_local_iq_to_global(
        mesh, np.zeros((2, 8), np.complex64), "cpu")
    assert row0 == 0 and iq.shape == (2, 8) and iq.device.type == "cpu"
    step, rows = tmesh.shard_demod_batch(
        tmesh.OFDMDemodulator(MODE, device="cpu"), mesh, 4)
    assert rows == (0, 4)


@pytest.mark.parametrize("rank, local_rank, card",
                         [(3, None, 3), (5, None, 1), (6, "2", 2)])
def test_initialize_picks_the_card_of_its_rank(monkeypatch, rank, local_rank,
                                               card):
    """With NCCL, initialize makes cuda:(LOCAL_RANK, else the rank it was
    given, modulo the cards) current before the group is up, and hands it
    to the group as its device: ranks started by hand, with neither RANK
    nor LOCAL_RANK set, each take their own card."""
    seen = {}
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    monkeypatch.setattr(distributed, "_initialized", False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: seen.setdefault("current", d))
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend,
                                                          **kw))
    assert distributed.initialize("file:///nowhere", 8, rank, "nccl")
    assert seen["current"] == torch.device("cuda", card)
    assert seen["device_id"] == torch.device("cuda", card)
    assert (seen["backend"], seen["rank"], seen["world_size"]) == \
        ("nccl", rank, 8)


def test_mesh_step_on_one_rank_is_receiver_step():
    """On the one-rank mesh the mesh step is the one-device round."""
    cfgs = [own(c) for c in LAYOUT]
    u8 = quantise_u8(capture(3, 3, 500.0)[None])
    (blk, tail), = u8_rounds(u8, F_LOC * FS, 1)
    a, (ca, ha, _) = tmesh.receiver_step(
        "cpu", MODE, F_LOC, subchannels_per_shard=4, ensembles_per_shard=1,
        ingest="u8", subchannel_cfgs=cfgs, fuse_fic=True)
    b, (cb, hb, _) = tmesh.multichip_receiver_step(
        tmesh.make_receiver_mesh(), MODE, F_LOC, subchannels_per_shard=4,
        ensembles_per_shard=1, ingest="u8", subchannel_cfgs=cfgs,
        fuse_fic=True, device="cpu")
    assert (b.rows, b.subs) == ((0, 1), (0, 4))
    oa, ob = a(ca, ha, blk, tail)[2], b(cb, hb, blk, tail)[2]
    assert all(torch.equal(oa[k], ob[k]) for k in oa)


def test_bad_mesh_arguments_raise():
    with pytest.raises(ValueError, match="split over"):
        tmesh.shard_demod_batch(tmesh.OFDMDemodulator(MODE, device="cpu"),
                                tmesh.ReceiverMesh((1, 1, 2)), 3)
    with pytest.raises(ValueError, match="sub ranks"):
        tmesh.multichip_receiver_step(
            tmesh.ReceiverMesh((1, 1, 2)), MODE,
            subchannel_cfgs=[own(c) for c in LAYOUT[:3]], device="cpu")
    with pytest.raises(ValueError, match="rows"):
        tmesh.multichip_receiver_step(
            tmesh.ReceiverMesh((2, 1, 1)), MODE, ensembles_per_shard=1,
            subchannel_cfgs=[[own(c) for c in LAYOUT]], device="cpu")


def test_rank_coordinates_are_row_major():
    """Rank r holds the shard that JAX's device r holds."""
    for axes in ((2, 2, 2), (1, 2, 2), (2, 1, 2), (4, 2, 1)):
        jm = jmesh_of(axes)
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        for r in range(int(np.prod(axes))):
            m = tmesh.ReceiverMesh(axes, r)
            assert ids[m.coords["ens"], m.coords["time"], m.coords["sub"]] \
                == jax.devices()[r].id


@pytest.mark.parametrize("name", ["aligned", "early_tail", "early_no_tail",
                                  "block_tracking"])
def test_timesharded_demod_matches_jax(two_ranks, name):
    """make_timesharded_demod over (1, 2, 1): the halo from the right
    neighbour, the tail on the last time rank, each shard's own carry. The
    block that starts 120 samples early needs the tail for its last frame:
    with it the frames are the transmitted ones, without it the last frame
    differs in both packages alike."""
    cases, ref, res = two_ranks
    key = f"demod_{name}"
    jcarry, jbits, joffs = ref[key]
    tcarry, (tbits, toffs) = res[key]
    assert_carry_close(jcarry, tcarry)
    np.testing.assert_array_equal(toffs, joffs)
    assert_soft_close(jbits, tbits, key)
    if name.startswith("early"):
        assert (toffs == 120).all()
    if name == "early_no_tail":
        # the last symbol of the last frame (2 * 384 soft bits in mode II)
        # reads zeros in place of the tail; the rest is the same
        with_tail = res["demod_early_tail"][1][0].reshape(2, -1)
        tbits = tbits.reshape(2, -1)
        sym = 2 * 384
        assert (np.abs(with_tail[:, -sym:].astype(np.int16)
                       - tbits[:, -sym:]) > 1).mean() > 0.05
        assert_soft_close(with_tail[:, :-sym], tbits[:, :-sym], key)


def test_coldstart_matches_jax(two_ranks):
    """The cold start over (1, 2, 1): the mean level over 'time', the
    earliest null dip elected by a MIN over 'time', the frames of each
    block at that phase."""
    cases, ref, res = two_ranks
    jcarry, jbits, jvalid = ref["coldstart"]
    tcarry, (tbits, tvalid) = res["coldstart"]
    assert_carry_close(jcarry, tcarry)
    np.testing.assert_array_equal(tvalid, jvalid)
    assert tvalid.sum(axis=(1, 2)).min() >= 2 * COLD_F_LOC - 2
    assert_soft_close(jbits[jvalid], tbits[tvalid], "coldstart bits")


@pytest.mark.parametrize("flags", list(STEP_FLAGS))
def test_step_over_sub_ranks_matches_jax(two_ranks, flags):
    """multichip_receiver_step over (1, 1, 2): two streams of a mixed
    EEP-A / UEP / EEP-B / EEP-A layout, each sub rank decoding two of the
    four subchannels, two rounds."""
    cases, ref, res = two_ranks
    key = f"step_1x1x2_{flags}"
    for jround, tround in zip(ref[key], res[key], strict=True):
        assert_round_close(jround, tround)
    if flags == "tiled":
        assert not res[key][-1][2]["msc_err"].any()


@pytest.mark.slow
def test_dryrun_on_eight_ranks(tmp_path):
    """The dry run over (2, 2, 2): two streams, two time blocks, two sub
    ranks, bit-exact against the port's one-device decoders."""
    report = run_dryrun(tmp_path, 8, None)
    assert report["mesh"] == {"ens": 2, "time": 2, "sub": 2}
