"""CUDA-graph capture of the port's device steps (``utils/graphs.py``), on
the CPU.

A CUDA graph exists only on the card, where tests/test_torch_cuda.py and
chip_smoke.py's phase ``graph`` hold every captured program against its
eager run, bit for bit. Here:

* ``CapturedProgram`` with ``cuda_graph=None`` on the CPU is the eager step,
  bit for bit, with and without a state held by the program;
* a program-held state of the fused round against the JAX package's jitted
  round over 3 rounds of 2 streams, with a ``load_state`` from the JAX
  state in the middle and a ``tail=None`` round (tolerances those of
  tests/test_torch_fused_round.py: the decoded bits and offsets are exact,
  the carried soft-bit history may differ by 1 LSB, ROADMAP F3);
* the callers under a graph's buffer semantics: ``Replayed`` stands on the
  CPU for a captured program, handing out its results in buffers that the
  next call of the same shapes overwrites, as a replay does. Through it
  ``FusedFleet`` (reset, resync, snapshot and resume) equals the JAX fleet,
  and ``MultiStreamDemodulator`` and ``StreamingDemodulator`` equal their
  eager runs while they keep carries and device bits across calls;
* every body that is captured makes no tensor from host data and reads no
  device value on the host: a dispatch mode watches every operation of its
  second call (the first call is the warm-up, which makes the tables that
  are cached per device);
* ``cuda_graph=True`` raises on a CPU device and with a mesh.
"""

import collections

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from dab_radio_tpu.models.channel import ChannelModel
from dab_radio_tpu.models.demodulator import OFDMDemodulator as JDemod
from dab_radio_tpu.models.multistream import MultiStreamDemodulator as JMulti
from dab_radio_tpu_torch.convert import fused_state_from_jax
from dab_radio_tpu_torch.kernels import viterbi_acs as K1
from dab_radio_tpu_torch.models.demodulator import (DemodCarry,
                                                    OFDMDemodulator,
                                                    StreamingDemodulator)
from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
from dab_radio_tpu_torch.models.multistream import MultiStreamDemodulator
from dab_radio_tpu_torch.parallel.mesh import (ReceiverMesh,
                                               multichip_receiver_step,
                                               receiver_step)
from dab_radio_tpu_torch.utils import graphs
from dab_radio_tpu_torch.utils.graphs import CapturedProgram

# helpers and module fixtures of the files that test the eager paths
from test_torch_fused_fleet import (AUDIO_CFGS, K as FLEET_K, JFleet, drive,
                                    full_run, make_tfleet, record)
from test_torch_fused_fleet import jax_runs, streams  # noqa: F401
from test_torch_fused_round import (F, LAYOUT_A, LAYOUT_B, MODE,
                                    assert_outputs_close, assert_state_close,
                                    build_both, own, rounds_u8)
from test_torch_fused_round import captures, mesh  # noqa: F401
from test_torch_multistream import CHUNK, as_ingest
from test_torch_multistream import streams as ms_streams  # noqa: F401

torch.set_num_threads(1)

CPU = torch.device("cpu")
STEP_KW = dict(ingest="u8", fuse_fic=True)


def stateful(step):
    """receiver_step's fn(carry, hist, iq, tail) as a program's function of
    (state, iq, tail)."""
    def fn(state, iq, tail):
        carry, hist, out = step(*state, iq, tail)
        return (carry, hist), out
    return fn


class Replayed:
    """Stands on the CPU for a captured program: runs the eager program it
    wraps, then hands out the results in buffers it keeps and overwrites on
    the next call of the same shapes, as a CUDA graph's replay does. numpy
    arguments arrive as numpy, as a captured program takes them."""
    captured = True

    def __init__(self, program):
        self.program, self._bufs = program, {}

    def __call__(self, *args):
        args = [torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray)
                else a for a in args]
        flat, spec = pytree.tree_flatten(self.program(*args))
        key = (spec, tuple(tuple(x.shape) if torch.is_tensor(x) else x
                           for x in flat))
        bufs = self._bufs.setdefault(key, [
            x.clone() if torch.is_tensor(x) else x for x in flat])
        for buf, x in zip(bufs, flat):
            if torch.is_tensor(buf):
                buf.copy_(x)
        return pytree.tree_unflatten(bufs, spec)

    def load_state(self, state):
        self.program.load_state(state)

    def read_state(self):
        return self.program.read_state()


def assert_same(a, b):
    fa, sa = pytree.tree_flatten(a)
    fb, sb = pytree.tree_flatten(b)
    assert sa == sb
    for x, y in zip(fa, fb):
        assert (x is None and y is None) or torch.equal(x, y)


# ---- the program on the CPU is the eager step ------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(block_tracking=True),
                                dict(viterbi="tiled")],
                         ids=["exact", "block_tracking", "tiled"])
def test_program_on_the_cpu_is_the_eager_step(captures, kw):
    """receiver_step on the CPU returns the plain function; a program of it
    with cuda_graph=None runs it eagerly, with the state passed in or held
    by the program: every output and the state bit-identical over three
    rounds, the last with tail=None."""
    cfgs = [own(c) for c in LAYOUT_A]
    step, (carry, hist, _) = receiver_step(
        "cpu", MODE, F, subchannels_per_shard=3, ensembles_per_shard=2,
        subchannel_cfgs=cfgs, **STEP_KW, **kw)
    assert not isinstance(step, CapturedProgram)
    plain = CapturedProgram(step, CPU)
    held = CapturedProgram(stateful(step), CPU, state=(carry, hist))
    assert not plain.captured and not held.captured and held.graphs == 0
    rounds = rounds_u8(captures, 3)
    rounds[-1] = (rounds[-1][0], None)
    state = (carry, hist)
    for blk, tail in rounds:
        *new, want = step(*state, blk, tail)
        assert_same(plain(*state, blk, tail), (*new, want))
        assert_same(held(blk, tail), want)
        assert_same(held.read_state(), tuple(new))
        state = tuple(new)
    # read_state hands out copies
    held.read_state()[1].fill_(5)
    assert_same(held.read_state(), state)


def test_program_state_against_jax(captures, mesh):
    """The round's state held by a program against the JAX package's jitted
    round: 3 rounds of 2 streams, JAX's state loaded into the program after
    the first, the last round without a tail."""
    (jstep, jstate), (tstep, tstate) = build_both(mesh, LAYOUT_A, 2,
                                                  **STEP_KW)
    prog = CapturedProgram(stateful(tstep), CPU, state=tuple(tstate))
    caps = [captures[0], ChannelModel(cfo_hz=-400.0, snr_db=20.0, seed=9)
            .apply(captures[0])]
    rounds = rounds_u8(caps, 3)
    rounds[-1] = (rounds[-1][0], None)
    for r, (blk, tail) in enumerate(rounds):
        if r == 1:
            carry, hist = fused_state_from_jax(*jstate)
            prog.load_state((DemodCarry.from_numpy(carry, CPU),
                             torch.from_numpy(hist)))
            got = prog.read_state()
            for a, b in zip((*carry, hist), (*got[0], got[1])):
                np.testing.assert_array_equal(b.numpy(), a)
        *jstate, jout = jstep(*jstate, blk, tail)
        tout = prog(blk, tail)
        assert_outputs_close(jout, tout, tout["msc_bits"].shape[-1] + 6)
        assert_state_close(jstate, prog.read_state())


def test_load_state_refuses_another_shape():
    prog = CapturedProgram(lambda s, x: (s, x), CPU,
                           state=(torch.zeros(2, 1), torch.zeros(3)))
    with pytest.raises(ValueError, match="does not fit"):
        prog.load_state((torch.zeros(2, 2), torch.zeros(3)))
    with pytest.raises(ValueError, match="does not fit"):
        prog.load_state((torch.zeros(2, 1), torch.zeros(3, dtype=torch.int8)))


def test_replay_adds_the_launches_its_capture_recorded():
    """K1's counters are registered; what a capture adds is taken back and
    added again on every replay."""
    assert K1.LAUNCHES in graphs.LAUNCH_COUNTERS
    assert K1.ACS_LAUNCHES_BY_T in graphs.LAUNCH_COUNTERS
    K1.reset_launches()
    before = graphs._read_counters()
    K1.LAUNCHES["viterbi_decode_fused"] += 1
    K1.ACS_LAUNCHES_BY_T[1542] += 1
    gained = graphs._undo_counters(before)
    assert K1.LAUNCHES == K1.launched() and not K1.ACS_LAUNCHES_BY_T
    for _ in range(3):
        graphs._add_counters(gained)
    assert K1.LAUNCHES == K1.launched(viterbi_decode_fused=3)
    assert K1.ACS_LAUNCHES_BY_T == {1542: 3}
    K1.reset_launches()


# ---- the callers under a replay's buffer semantics --------------------------

def replayed_fleet(**kw):
    fleet = make_tfleet(**kw)
    fleet.program = Replayed(fleet.program)
    return fleet


@pytest.mark.parametrize("what", ["reset", "resync", "snapshot"])
def test_fused_fleet_with_replayed_program_matches_jax(streams, jax_runs,
                                                       what):
    """FusedFleet whose program hands out its outputs in reused buffers and
    holds the state in its own: the events, health signals and summary of
    the JAX fleet after a reset, a resync after 5 rounds, and a snapshot
    taken after 5 rounds and resumed. (On the card the fetch copies the
    outputs to pinned memory right after the replay; the direct fetch
    reads them before the next round here.)"""
    if what == "reset":
        fleet = replayed_fleet()
        first = full_run(fleet, streams, defer=False)
        fleet.reset()
        del fleet.on_access_unit[:], fleet.on_mp2_frame[:]
        del fleet.on_data_group[:]
        assert full_run(fleet, streams, defer=False) == first \
            == jax_runs[False]
        return

    def run(fleet, make_resumed):
        events, health = record(fleet), []
        drive(fleet, streams, range(5), False, health)
        fleet, events2 = make_resumed(fleet)
        drive(fleet, streams, range(5, 11), False, health)
        return events + events2, health, fleet.summary()

    if what == "resync":
        def again(fleet):
            fleet.resync()
            return fleet, []
        got = run(replayed_fleet(), again)
        assert got == run(JFleet(2, AUDIO_CFGS, MODE, FLEET_K), again)
    else:
        def resumed(fleet):
            new = FusedFleet.from_snapshot(fleet.snapshot(), CPU)
            new.program = Replayed(new.program)
            return new, record(new)
        got = run(replayed_fleet(), resumed)
        want = jax_runs[False]
        assert (got[0], got[2]) == (want["events"], want["summary"])
    assert got[2]["access_units"] > 0


def replayed_demod():
    demod = OFDMDemodulator(MODE, device=CPU)
    demod._step_program = Replayed(demod._step_program)
    demod._scan_program = Replayed(demod._scan_program)
    return demod


def push_all(ms, streams, ingest):
    """Push the streams chunk by chunk and step until nothing comes; the
    frames are kept as they come (rows of device tensors with fetch_bits
    off) and read only at the end."""
    per = 2 * CHUNK if ingest == "u8" else CHUNK
    data = [as_ingest(s, ingest) for s in streams]
    frames = []
    for lo in range(0, max(d.shape[0] for d in data), per):
        for i, d in enumerate(data):
            if lo < d.shape[0]:
                ms.push(i, d[lo:lo + per])
        while True:
            res = ms.step()
            if not res:
                break
            frames += res
    return [(i, np.asarray(b)) for i, b in frames]


@pytest.mark.parametrize("K", [1, 2])
def test_multistream_keeps_carry_and_bits_across_replays(ms_streams, K):
    """MultiStreamDemodulator whose round program (the frame step or scan
    and the masked merge, with the carry held by the program) reuses its
    output buffers: the frames' device bits are kept over later calls and
    equal the eager run's, as does the carry, and the JAX batch emits the
    same frames."""
    kw = dict(frames_per_step=K, ingest="u8", fetch_bits=False, device=CPU)
    eager = MultiStreamDemodulator(OFDMDemodulator(MODE, device=CPU), 3, **kw)
    replay = MultiStreamDemodulator(OFDMDemodulator(MODE, device=CPU), 3,
                                    **kw)
    replay.program = Replayed(replay.program)
    want, got = push_all(eager, ms_streams, "u8"), push_all(
        replay, ms_streams, "u8")
    assert [i for i, _ in got] == [i for i, _ in want]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))
    assert_same(replay.carry, eager.carry)
    assert int(replay.carry.total_desync[1]) >= 1
    jms = JMulti(JDemod(MODE), 3, frames_per_step=K, ingest="u8")
    assert [i for i, _ in push_all(jms, ms_streams, "u8")] == \
        [i for i, _ in got]


@pytest.mark.parametrize("K", [1, 2])
def test_streaming_demod_keeps_its_carry_across_replays(ms_streams, K):
    """StreamingDemodulator through a loss of lock and a re-acquisition
    (which reads the previous carry's counters after building the new
    one), on programs that reuse their output buffers: the eager run's
    frames and carry."""
    iq = ms_streams[1]
    runs = []
    for demod in (OFDMDemodulator(MODE, device=CPU), replayed_demod()):
        sd = StreamingDemodulator(demod, frames_per_step=K)
        frames = []
        for lo in range(0, iq.shape[0], CHUNK):
            frames += sd.process(iq[lo:lo + CHUNK])
        runs.append((frames, sd.carry))
    (want, wc), (got, gc) = runs
    assert len(got) == len(want) > 20
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert_same(gc, wc)
    assert int(gc.total_desync) >= 1


# ---- what is captured touches nothing on the host ------------------------

class HostTraffic(TorchDispatchMode):
    """Counts the operations that a CUDA graph cannot hold: a tensor made
    from host data (lift_fresh: a copy from the host on the card) and a
    device value read on the host (a synchronisation)."""
    WATCHED = ("aten.lift_fresh.default", "aten._local_scalar_dense.default",
               "aten.nonzero.default", "aten.item.default")

    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) in self.WATCHED:
            self.seen[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def k1_stubbed(monkeypatch):
    """K1's wrappers as zeros of their output shapes: on the card they
    launch a kernel; their plain versions (CPU only) make tables."""
    def decode(d, start_state=0, end_state=0):
        return (torch.zeros(d.shape[:2], dtype=torch.int8),
                torch.zeros(d.shape[:1], dtype=torch.int32))

    def acs(d, start_state=0, end_state=0):
        return (torch.zeros(d.shape[1::-1], dtype=torch.int64),
                torch.zeros(d.shape[:1], dtype=torch.int32))
    monkeypatch.setattr(K1, "decode", decode)
    monkeypatch.setattr(K1, "viterbi_acs", acs)
    monkeypatch.setattr(K1, "decode_windows",
                        lambda d, first: torch.zeros(d.shape[:2],
                                                     dtype=torch.int8))


ROUND_FLAGS = [dict(), dict(block_tracking=True), dict(viterbi="tiled"),
               dict(fuse_fic=False), dict(chainback="parallel"),
               dict(chainback="fused"), dict(viterbi_branch="lut"),
               dict(viterbi="radix8"), dict(ingest="pairs"),
               dict(per_stream=True)] + [
    dict(stop_after=s) for s in ("ingest", "demod", "subs", "deint",
                                 "depunct", "acs")] + [
    dict(stop_after="acs", viterbi_branch="lut")]


@pytest.mark.parametrize("kw", ROUND_FLAGS,
                         ids=lambda kw: "-".join(map(str, kw.values()))
                         or "default")
def test_round_body_has_no_host_traffic(k1_stubbed, kw):
    kw = dict(kw)
    cfgs = [own(c) for c in LAYOUT_A]
    if kw.pop("per_stream", False):
        cfgs = [cfgs, [own(c) for c in LAYOUT_B]]
    args = dict(ingest="u8", fuse_fic=True)
    args.update(kw)
    step, (carry, hist, iq) = receiver_step(
        "cpu", MODE, F, subchannels_per_shard=3, ensembles_per_shard=2,
        subchannel_cfgs=cfgs, **args)
    halo = step.tail_samples
    tail = torch.full((2, 2 * halo), 127, dtype=torch.uint8) \
        if args["ingest"] == "u8" else torch.zeros((2, halo, 2))
    for t in (tail, None):
        step(carry, hist, iq, t)                # the warm-up
        watch = HostTraffic()
        with watch:
            step(carry, hist, iq, t)
        assert not watch.seen, (t is None, dict(watch.seen))


@pytest.mark.parametrize("entry", ["frame_step", "frame_step_batch",
                                   "frame_scan", "frame_scan_batch"])
def test_demod_body_has_no_host_traffic(entry):
    demod = OFDMDemodulator(MODE, device=CPU)
    B = () if entry in ("frame_step", "frame_scan") else (3,)
    carry = DemodCarry.init(B, device=CPU)._replace(
        signal_l1_avg=torch.full(B, 0.5))
    rng = np.random.default_rng(5)
    if entry.startswith("frame_scan"):
        n = 2 * demod.frame_advance + demod.window_len
        fn, args = demod._frame_scan_impl, (2, carry)
    else:
        n = demod.window_len
        fn, args = demod._frame_step_impl, (carry,)
    iq = torch.from_numpy((rng.normal(size=B + (n,)) + 1j * rng.normal(
        size=B + (n,))).astype(np.complex64))
    fn(*args, iq)
    watch = HostTraffic()
    with watch:
        fn(*args, iq)
    assert not watch.seen, dict(watch.seen)


# ---- what cuda_graph=True refuses -----------------------------------------

@pytest.mark.parametrize("build", [
    lambda: CapturedProgram(lambda x: x, CPU, cuda_graph=True),
    lambda: receiver_step("cpu", MODE, 1, subchannels_per_shard=1,
                          ensembles_per_shard=1, cuda_graph=True),
    lambda: OFDMDemodulator(MODE, device=CPU, cuda_graph=True),
    lambda: FusedFleet(1, [own(c) for c in LAYOUT_A], MODE, 1, device=CPU,
                       cuda_graph=True)],
    ids=["program", "receiver_step", "demodulator", "fused_fleet"])
def test_cuda_graph_true_raises_on_the_cpu(build):
    with pytest.raises(ValueError, match="cuda_graph=True needs a CUDA"):
        build()


def test_cuda_graph_true_raises_with_a_mesh(tmp_path):
    """A mesh over gloo stays eager (gloo moves a CUDA tensor through host
    memory): True raises ValueError naming gloo, the default runs the plain
    function. A mesh without a process group has no collective: it takes
    cuda_graph as one device does (True on the CPU raises, the default is
    eager here)."""
    import torch.distributed as dist
    from dab_radio_tpu_torch.parallel.mesh import (
        make_coldstart_timesharded_demod, make_receiver_mesh,
        make_timesharded_demod)
    kw = dict(subchannels_per_shard=1, ensembles_per_shard=1, device=CPU)
    one = ReceiverMesh((1, 1, 1))
    with pytest.raises(ValueError, match="needs a CUDA"):
        multichip_receiver_step(one, MODE, 1, cuda_graph=True, **kw)
    step, _ = multichip_receiver_step(one, MODE, 1, **kw)
    assert not isinstance(step, CapturedProgram)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        mesh = make_receiver_mesh(1)
        demod = OFDMDemodulator(MODE, device=CPU)
        for build in (
                lambda g: multichip_receiver_step(mesh, MODE, 1,
                                                  cuda_graph=g, **kw),
                lambda g: FusedFleet(1, [own(c) for c in LAYOUT_A], MODE, 1,
                                     device=CPU, mesh=mesh, cuda_graph=g),
                lambda g: make_timesharded_demod(demod, 1, mesh=mesh,
                                                 cuda_graph=g),
                lambda g: make_coldstart_timesharded_demod(demod, mesh, 1,
                                                           cuda_graph=g)):
            with pytest.raises(ValueError, match="gloo"):
                build(True)
        step, _ = multichip_receiver_step(mesh, MODE, 1, **kw)
        assert not isinstance(step, CapturedProgram)
        fleet = FusedFleet(1, [own(c) for c in LAYOUT_A], MODE, 1,
                           device=CPU, mesh=mesh)
        assert not fleet.program.captured
    finally:
        dist.destroy_process_group()


def test_replay_adds_the_collectives_its_capture_recorded():
    """COLLECTIVES' calls are counted on a replay, through Replayed made to
    keep the counters as a captured program does (the warm-up counts, the
    capture is undone, each replay adds what the capture recorded); its
    host seconds count the eager call alone."""
    from dab_radio_tpu_torch.parallel import mesh as M
    assert M.COLLECTIVES in graphs.LAUNCH_COUNTERS

    def two_collectives(x):
        for _ in range(2):
            with M._counted():
                x = x + 1
        return x

    class CountingReplayed(Replayed):
        """The counter bookkeeping of CapturedProgram around Replayed: the
        first call is the warm-up, then a capture whose counts are undone
        and recorded; a later call counts what the capture recorded."""
        gained = None

        def __call__(self, *args):
            if self.gained is None:
                out = super().__call__(*args)           # the warm-up
                before = graphs._read_counters()
                super().__call__(*args)                 # the capture
                self.gained = graphs._undo_counters(before)
                return out
            before = graphs._read_counters()
            out = super().__call__(*args)
            graphs._undo_counters(before)               # no Python runs
            graphs._add_counters(self.gained)
            return out

    M.reset_collectives()
    prog = CountingReplayed(CapturedProgram(two_collectives, CPU))
    prog(torch.zeros(2))
    warm = dict(M.COLLECTIVES)
    assert warm["calls"] == 2 and warm["seconds"] > 0
    for _ in range(3):
        assert torch.equal(prog(torch.zeros(2)), torch.full((2,), 2.0))
    assert M.COLLECTIVES["calls"] == 2 + 3 * 2
    assert M.COLLECTIVES["seconds"] == warm["seconds"]
    M.reset_collectives()


def test_shutdown_frees_the_graphs_that_hold_collectives(tmp_path):
    """A program captured with a mesh's collectives inside is noted, and
    distributed.shutdown() frees its graphs before it takes the process
    group down (NCCL waits for ever to take down a communicator that a
    live graph uses); a program without collectives is not noted."""
    from dab_radio_tpu_torch.parallel import distributed
    from dab_radio_tpu_torch.parallel import mesh as M

    class Held:
        captured, device, released = True, CPU, 0

        def release(self):
            self.released += 1
    assert distributed.initialize(f"file://{tmp_path}/rdzv", 1, 0, "gloo")
    try:
        mesh = M.make_receiver_mesh(1)
        held, alone = Held(), Held()
        assert M.track_collectives(held, mesh) is held
        M.track_collectives(alone, ReceiverMesh((1, 1, 1)))
        M.track_collectives(CapturedProgram(torch.neg, CPU), mesh)
        assert list(M._COLLECTIVE_PROGRAMS) == [held]
    finally:
        distributed.shutdown()
    assert held.released == 1 and alone.released == 0
