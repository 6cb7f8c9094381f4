"""Helpers of tests/test_torch_parallel_*.py: ranks of a gloo process group
started as processes on the CPU, the cases they run, and the comparisons
with the JAX package.

The ranks run ``python -c RANK_SCRIPT`` (the port alone is imported there,
never this module or JAX), with a file rendezvous in a temporary directory;
the cases go to them and rank 0's results come back as pickles of numpy
arrays. ``run_ranks`` computes the JAX reference in the test process while
they run, and kills them if it fails.
"""

import json
import os
import pickle
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from dab_radio_tpu.models.channel import ChannelModel
from dab_radio_tpu.models.demodulator import (DemodCarry as JCarry,
                                              OFDMDemodulator as JDemod)
from dab_radio_tpu.models.transmitter import EnsembleTransmitter, ServiceSpec
from dab_radio_tpu.parallel import mesh as jmesh
from dab_radio_tpu.params import SubchannelConfig as JCfg
from dab_radio_tpu_torch.convert import subchannel_config_from_jax as own
from dab_radio_tpu_torch.parallel import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODE = 2
FS = 49152                          # samples of a mode-II frame
HALO = JDemod(MODE).window_len - FS
LAYOUT = [JCfg(0, 12, False, eep_type="A", eep_prot_level=2),
          JCfg(12, 16, True, uep_table_index=0),
          JCfg(28, 21, False, eep_type="B", eep_prot_level=1),
          JCfg(49, 12, False, eep_type="A", eep_prot_level=0)]
RANK_TIMEOUT_S = 240

# what each rank runs: the cases of cases.pkl, in order, the results of
# rank 0 into results.pkl
RANK_SCRIPT = textwrap.dedent('''
    import pickle, sys
    from datetime import timedelta
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from dab_radio_tpu_torch.models.demodulator import (DemodCarry,
                                                        OFDMDemodulator)
    from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
    from dab_radio_tpu_torch.parallel import distributed as D
    from dab_radio_tpu_torch.parallel import mesh as M
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    assert D.initialize("file://" + work + "/rdzv", world, rank, "gloo",
                        timedelta(seconds=120))
    with open(work + "/cases.pkl", "rb") as f:
        cases = pickle.load(f)

    def local(mesh, x, block=True):
        """This rank's rows of x and, with block, its time block."""
        n = x.shape[0] // mesh.shape["ens"]
        x = x[mesh.coords["ens"] * n:(mesh.coords["ens"] + 1) * n]
        if block:
            m = x.shape[1] // mesh.shape["time"]
            x = x[:, mesh.coords["time"] * m:(mesh.coords["time"] + 1) * m]
        return torch.from_numpy(np.ascontiguousarray(x))

    def gather_time(mesh, carry, *xs):
        """carry fields (B, n_time) and xs (B, n_time, ...) on rank 0."""
        parts = M._gather_objects(mesh, (mesh.coords, [
            [x.numpy() for x in carry], [x.numpy() for x in xs]]), 0)
        if parts is None:
            return None
        by = {(c["ens"], c["time"]): v for c, v in parts if c["sub"] == 0}
        n_ens, n_time = mesh.shape["ens"], mesh.shape["time"]
        def cat(k, i):
            return np.concatenate([np.concatenate(
                [by[(e, t)][k][i] for t in range(n_time)], axis=1)
                for e in range(n_ens)])
        return ([cat(0, i) for i in range(len(carry))],
                [cat(1, i) for i in range(len(xs))])

    def demod(c, mesh):
        fn = M.make_timesharded_demod(OFDMDemodulator(2, device="cpu"),
                                      c["f_loc"], c["block_tracking"],
                                      mesh=mesh)
        iq = local(mesh, c["iq"])
        B = iq.shape[0]
        carry = DemodCarry.init((B, 1), device="cpu")._replace(
            signal_l1_avg=torch.full((B, 1), 0.5))
        tail = None if c["tail"] is None else local(mesh, c["tail"], False)
        return gather_time(mesh, *fn(carry, iq, tail))

    def coldstart(c, mesh):
        fn = M.make_coldstart_timesharded_demod(
            OFDMDemodulator(2, device="cpu"), mesh, c["f_loc"])
        return gather_time(mesh, *fn(local(mesh, c["iq"])))

    def step(c, mesh):
        fn, (carry, hist, _) = M.multichip_receiver_step(
            mesh, 2, c["f_loc"], device="cpu", **c["kw"])
        assert fn.rows == (mesh.coords["ens"] * c["kw"]["ensembles_per_shard"],
                           (mesh.coords["ens"] + 1)
                           * c["kw"]["ensembles_per_shard"])
        rounds = []
        for blk, tail in c["rounds"]:
            carry, hist, out = fn(carry, hist, local(mesh, blk),
                                  local(mesh, tail, False))
            rounds.append(M.gather_round(mesh, carry, hist, out))
        return rounds if mesh.rank == 0 else None

    def fleet(c, mesh):
        """The fleet's AUs (global stream numbers) over the rounds, each
        rank's health signals after them, the leaders' summaries and labels, the snapshot after them (rank 0),
        and for each mesh of restore_on the AUs of more_rounds after a
        restore there, or the refusal."""
        def serve(f, rounds):
            aus = []
            f.on_access_unit.append(
                lambda b, s, i, n, au, h: aus.append((b, s, bytes(au))))
            for blk, tail in rounds:
                f.process_round(blk, tail_u8=tail)
            return aus
        f = FusedFleet(c["N"], c["cfgs"], 2, c["K"], device="cpu", mesh=mesh)
        res = {"rank": rank, "rows": f.rows, "aus": serve(f, c["rounds"]),
               "health": (f.drift_correction, f.last_fib_ok,
                          f.materialized_rounds)}
        if mesh.is_leader:
            res["summary"] = f.summary()
            res["labels"] = [rx.db.ensemble.label for rx in f.receivers]
        blob = [f.snapshot()]
        res["snapshot"] = blob[0]
        torch.distributed.broadcast_object_list(blob, src=0)
        res["restored"] = {}
        for name, axes in c["restore_on"].items():
            other = M.make_receiver_mesh(axis_sizes=axes)
            try:
                g = FusedFleet.from_snapshot(blob[0], "cpu", mesh=other)
            except ValueError as e:
                res["restored"][name] = str(e)
                continue
            res["restored"][name] = (serve(g, c["more_rounds"]),
                                     g.summary() if other.is_leader else None)
        return M._gather_objects(mesh, res, 0)

    def multistream(c, mesh):
        """MultiStreamDemodulator(mesh=) (after loading c["state"], the JAX
        batch's, when given) into a ReceiverFleet of this rank's streams:
        the frames (round, global stream, bits) and access units by global
        stream, and this rank's state after them; or the mesh's refusal."""
        from dab_radio_tpu_torch.models.fleet import ReceiverFleet
        from dab_radio_tpu_torch.models.multistream import (
            MultiStreamDemodulator)
        try:
            ms = MultiStreamDemodulator(
                OFDMDemodulator(2, device="cpu"), len(c["chunks"][0]),
                ingest="u8", device="cpu", mesh=mesh)
        except ValueError as e:
            return M._gather_objects(mesh, {"rank": rank, "refused": str(e)},
                                     0)
        if c["state"] is not None:
            ms.load_state(c["state"])
        lo, hi = ms.rows
        fleet, aus = ReceiverFleet(hi - lo, 2, device="cpu"), {}
        for k, rx in enumerate(fleet.receivers):
            def on_channel(sub_id, ch, b=lo + k):
                ch.events.on_access_unit.append(
                    lambda i, n, au, hdr: aus.setdefault(b, []).append(
                        (sub_id, bytes(au))))
            rx.on_audio_channel.append(on_channel)
        frames, rnd = [], 0
        for chunk in c["chunks"]:
            for b in range(lo, hi):
                ms.push(b, chunk[b])
            while True:
                res = ms.step()
                rnd += 1
                if not res:
                    break
                frames += [(rnd, b, np.array(bits)) for b, bits in res]
                fleet.process_frames([(b - lo, bits) for b, bits in res])
        fleet.flush()
        return M._gather_objects(mesh, {
            "rank": rank, "rows": (lo, hi), "frames": frames, "aus": aus,
            "tracking": ms.tracking.tolist(),
            "unread": [x.shape[0] for x in ms.bufs],
            "carry": [x.numpy() for x in ms.carry],
            "labels": [rx.db.ensemble.label for rx in fleet.receivers]}, 0)

    RUN = {"demod": demod, "coldstart": coldstart, "step": step,
           "fleet": fleet, "multistream": multistream}
    results = {}
    for name, case in cases.items():
        mesh = M.make_receiver_mesh(axis_sizes=case["axes"])
        results[name] = RUN[case["kind"]](case, mesh)
    if rank == 0:
        with open(work + "/results.pkl", "wb") as f:
            pickle.dump(results, f)
    D.shutdown()
    print("RANK_OK", rank)
''')


def run_ranks(work, world, cases, reference):
    """Start `world` ranks on the cases, compute reference() meanwhile, and
    return (reference's result, rank 0's results)."""
    with open(os.path.join(work, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=ROOT)
    ranks = dryrun.Ranks([[sys.executable, "-c", RANK_SCRIPT, str(r),
                           str(world), str(work)] for r in range(world)],
                         cwd=ROOT, env=env)
    try:
        ref = reference()
    except BaseException:
        ranks.kill()
        raise
    outs = ranks.wait(RANK_TIMEOUT_S)
    assert all(rc == 0 and "RANK_OK" in text for rc, text in outs), "\n".join(
        f"rank {r} exited with {rc}:\n{text[-3000:]}"
        for r, (rc, text) in enumerate(outs))
    with open(os.path.join(work, "results.pkl"), "rb") as f:
        return ref, pickle.load(f)


def jmesh_of(axes):
    return jmesh.make_receiver_mesh(int(np.prod(axes)), axis_sizes=axes)


def capture(seed, nb_frames, cfo_hz, lead=0):
    """A noisy mode-II capture of the 4-subchannel layout (complex64)."""
    tx = EnsembleTransmitter(
        MODE, ensemble_id=0xC000 + seed,
        services=[ServiceSpec(0xF000 + 16 * seed + s, s, f"S{seed}{s}", c)
                  for s, c in enumerate(LAYOUT)])
    iq = ChannelModel(cfo_hz=cfo_hz, snr_db=18.0, seed=seed).apply(
        tx.generate(nb_frames))
    iq = np.concatenate([np.zeros(lead, iq.dtype), iq])
    return (iq / np.abs(iq).max() * 0.5).astype(np.complex64)


def quantise_u8(iq):
    pairs = iq.view(np.float32).reshape(iq.shape[0], -1)
    return np.clip(np.round(pairs * 127.5 + 127.5), 0, 255).astype(np.uint8)


def u8_rounds(u8, T, nb_rounds):
    return [(u8[:, 2 * T * r:2 * T * (r + 1)],
             u8[:, 2 * T * (r + 1):2 * T * (r + 1) + 2 * HALO])
            for r in range(nb_rounds)]


def assert_soft_close(a, b, what):
    d = np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16))
    assert a.shape == b.shape, what
    assert d.max() <= 1 and np.mean(d > 0) <= 5e-3, what


def assert_carry_close(jcarry, tcarry):
    for name, a, b in zip(JCarry._fields, jcarry, tcarry):
        a = np.asarray(a)
        assert a.shape == b.shape, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


F_LOC = 2                           # frames a time rank a round
STEP_FLAGS = {"default": {}, "fuse_fic": dict(fuse_fic=True),
              "tiled": dict(viterbi="tiled", fuse_fic=True)}


def step_cases(u8, axes, flags=STEP_FLAGS, nb_rounds=2):
    """The mesh step on two streams of the 4-subchannel layout over
    `axes`, two rounds of n_time * F_LOC frames, with each set of flags."""
    n_ens, n_time, n_sub = axes
    T = n_time * F_LOC * FS
    return {f"step_{'x'.join(map(str, axes))}_{name}": dict(
        kind="step", axes=axes, f_loc=F_LOC, flags=kw,
        kw=dict(subchannels_per_shard=len(LAYOUT) // n_sub,
                ensembles_per_shard=2 // n_ens, ingest="u8",
                subchannel_cfgs=[own(c) for c in LAYOUT], **kw),
        rounds=u8_rounds(u8, T, nb_rounds)) for name, kw in flags.items()}


def step_reference(case):
    axes = case["axes"]
    mesh = jmesh_of(axes)
    kw = dict(case["kw"], subchannel_cfgs=LAYOUT)
    fn, (carry, hist, _) = jmesh.multichip_receiver_step(
        mesh, MODE, case["f_loc"], **kw)
    rounds = []
    for blk, tail in case["rounds"]:
        blk = jax.device_put(jnp.asarray(blk),
                             NamedSharding(mesh, P("ens", "time")))
        carry, hist, out = fn(carry, hist, blk, jnp.asarray(tail))
        rounds.append(([np.asarray(x) for x in carry], np.asarray(hist),
                       {k: np.asarray(v) for k, v in out.items()}))
    return rounds


def assert_round_close(jround, tround):
    (jc, jh, jout), (tc, th, tout) = jround, tround
    assert_carry_close(jc, tc)
    assert_soft_close(jh, th, "deint_hist")
    assert sorted(jout) == sorted(tout)
    for k in ("fib_bits", "msc_bits", "offsets"):
        assert jout[k].shape == tout[k].shape, k
        np.testing.assert_array_equal(tout[k], jout[k], err_msg=k)
    nb_steps = tout["msc_bits"].shape[-1] + 6
    for k in ("fic_err", "msc_err"):
        assert jout[k].shape == tout[k].shape, k
        assert np.abs(jout[k].astype(np.int64) - tout[k]).max() \
            <= 0.005 * 4 * nb_steps, k


def run_dryrun(work, world, axes):
    init = f"file://{work}/rdzv"
    outs = dryrun.launch([dryrun.rank_command(r, world, init, axes, "cpu")
                          for r in range(world)], RANK_TIMEOUT_S, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    for r, (rc, text) in enumerate(outs):
        assert rc == 0, f"rank {r} ({rc}):\n{text[-4000:]}"
    line, = [ln for ln in outs[0][1].splitlines() if ln.startswith("dryrun: ")]
    report = json.loads(line[len("dryrun: "):])
    assert report["bit_exact"] and report["fibs"] > 0 and report["payloads"] > 0
    assert report["backend"] == "gloo" and len(report["ranks"]) == world
    assert not any(r["loaded_jax"] for r in report["ranks"])
    return report


MS_CHUNK = 3 * FS + 1111             # samples a stream pushes at a time


def multistream_chunks(u8):
    """The (N, 2 * samples) u8 streams as pushes of MS_CHUNK samples."""
    step = 2 * MS_CHUNK
    return [[row[lo:lo + step] for row in u8]
            for lo in range(0, u8.shape[1], step)]


def drive_multistream(ms, fleet, chunks):
    """What the rank script's multistream case does, on the JAX pair: the
    frames (round, stream, bits) and the access units by stream."""
    aus, frames, rnd = {}, [], 0
    for k, rx in enumerate(fleet.receivers):
        def on_channel(sub_id, ch, b=k):
            ch.events.on_access_unit.append(
                lambda i, n, au, hdr: aus.setdefault(b, []).append(
                    (sub_id, bytes(au))))
        rx.on_audio_channel.append(on_channel)
    for chunk in chunks:
        for b, data in enumerate(chunk):
            ms.push(b, data)
        while True:
            res = ms.step()
            rnd += 1
            if not res:
                break
            frames += [(rnd, b, np.array(bits)) for b, bits in res]
            fleet.process_frames(res)
    fleet.flush()
    return frames, aus


def jax_multistream(n, axes):
    """The JAX MultiStreamDemodulator of n u8 streams with its windows'
    rows split over a mesh of `axes` (the 'ens' axis)."""
    from dab_radio_tpu.models.multistream import MultiStreamDemodulator
    return MultiStreamDemodulator(
        JDemod(MODE), n, ingest="u8",
        sharding=NamedSharding(jmesh_of(axes), P("ens")))
