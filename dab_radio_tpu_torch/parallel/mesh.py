"""The fused receiver round, on one device or over a mesh of GPU ranks
(port of ``dab_radio_tpu/parallel/mesh.py``).

One call of the step takes ``frames_per_shard`` frames of raw IQ for each of
B streams and returns their decoded, descrambled FIB and subchannel bits:

  u8 dequantise -> frame scan on the fixed grid f * frame_samples, with the
  ``tail`` halo behind the block -> FIC soft slice / per-subchannel CIF
  slices -> 16-CIF block deinterleave (history carried) -> padded depuncture
  -> ONE Viterbi decode of every lane (kernel K1 on a CUDA device) ->
  descramble.

It is plain functions on tensors of the step's device; only the Viterbi
decode is a hand-written kernel (``kernels/viterbi_acs.py``), and only with
the default ``chainback`` and ``viterbi_branch``: the other decode variants
are torch loops over the trellis (``ops/viterbi.py``).

``receiver_step`` is the round on one device. ``multichip_receiver_step``
is the same round over a ``ReceiverMesh``: one process a GPU rank, the
mesh's three axes as ``torch.distributed`` process groups, NCCL between
cards and gloo on the CPU (or between ranks that share one card):

  'ens'  - streams, data parallel: a rank holds its ens coordinate's rows;
  'time' - frame blocks of one stream, sequence parallel: each rank
           demodulates its block with the first samples of its right
           neighbour's block as the halo, then the frames are gathered;
  'sub'  - subchannels: each rank decodes its S / n_sub of them.

Both run one body: ``receiver_step`` is ``multichip_receiver_step``
without a mesh, and the mesh adds the collectives around the round. On a
CUDA device the round, the time-sharded demod and the cold start run as
captured CUDA graphs (``utils/graphs.py``), the collectives inside them,
when the mesh's collectives run over NCCL (or there are none); over gloo
they stay eager, since gloo moves a CUDA tensor through host memory.
"""

import time
import weakref
from contextlib import contextmanager

import numpy as np
import torch
import torch.distributed as dist

from ..models.demodulator import OFDMDemodulator, DemodCarry, _select
from ..ops import sync as sync_ops
from ..utils.backend import to_device
from ..utils import graphs
from ..utils.graphs import CapturedProgram, use_graph

STOP_AFTER = (None, "ingest", "demod", "subs", "deint", "depunct", "acs")
AXES = ("ens", "time", "sub")


def _u8_to_complex(u8: torch.Tensor) -> torch.Tensor:
    """(B, 2n) interleaved uint8 IQ -> (B, n) complex64. The scale is a
    multiply by the float32 reciprocal, as the JAX step forms it: a divide
    differs from it by an ulp on some codes."""
    f = (u8.to(torch.float32) - 127.5) * np.float32(1.0 / 127.5)
    return torch.view_as_complex(f.reshape(u8.shape[0], -1, 2))


def _pairs_to_complex(x: torch.Tensor) -> torch.Tensor:
    """(B, n, 2) float32 IQ pairs -> (B, n) complex64."""
    return torch.view_as_complex(x.to(torch.float32).contiguous())


# ---- the mesh -------------------------------------------------------------

def mesh_axis_sizes(n: int) -> tuple:
    """The factoring of n ranks into ('ens', 'time', 'sub'): 'sub' and
    'time' each take one factor of 2 when there is one, the rest goes to
    'ens'. 8 -> (2, 2, 2), 16 -> (4, 2, 2), 4 -> (1, 2, 2), 2 -> (1, 1, 2),
    odd n -> (n, 1, 1)."""
    if n <= 0:
        raise ValueError(f"a mesh needs at least one rank, got {n}")
    sub = 2 if n % 2 == 0 else 1
    time_ = 2 if (n // sub) % 2 == 0 else 1
    return (n // (sub * time_), time_, sub)


class ReceiverMesh:
    """This rank's place in the ('ens', 'time', 'sub') mesh.

    ``shape`` maps each axis to its size, ``coords`` to this rank's
    coordinate; rank r sits at the row-major position r of the axis sizes,
    so that rank r holds the rows that shard r of a JAX mesh of the same
    sizes holds. ``groups`` maps each axis to the process group of the line
    through this rank along it, or is None for the one-rank mesh without a
    process group, on which every collective is the identity."""

    def __init__(self, axis_sizes, rank: int = 0, groups=None):
        self.axis_sizes = tuple(int(a) for a in axis_sizes)
        self.shape = dict(zip(AXES, self.axis_sizes))
        self.size = int(np.prod(self.axis_sizes))
        self.rank = rank
        self.coords = dict(zip(AXES, (int(c) for c in np.unravel_index(
            rank, self.axis_sizes))))
        self.groups = groups

    def group(self, axis: str):
        return None if self.groups is None else self.groups[axis]

    @property
    def is_leader(self) -> bool:
        """Whether this rank is its ens group's first (time 0, sub 0)."""
        return self.coords["time"] == 0 and self.coords["sub"] == 0

    def __repr__(self):
        return (f"ReceiverMesh({self.shape}, rank={self.rank}, "
                f"coords={self.coords})")


def make_receiver_mesh(n: int = None, axis_sizes=None) -> ReceiverMesh:
    """The mesh of this process group's n ranks (default: all of them; 1
    when no process group is up). axis_sizes overrides the factoring of
    ``mesh_axis_sizes``. Every rank must call it, with the same arguments
    and in the same order as the other ranks: it makes one process group
    for each line of each axis."""
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    n = world if n is None else n
    if n != world:
        raise ValueError(f"a mesh of {n} ranks needs a process group of {n} "
                         f"ranks, this process is in one of {world}")
    if axis_sizes is None:
        axis_sizes = mesh_axis_sizes(n)
    if int(np.prod(axis_sizes)) != n or len(axis_sizes) != 3:
        raise ValueError(f"axis sizes {tuple(axis_sizes)} do not factor {n}")
    if not up:
        return ReceiverMesh(axis_sizes)
    rank = dist.get_rank()
    ranks = np.arange(n).reshape(axis_sizes)
    groups = {}
    for i, axis in enumerate(AXES):
        for line in np.moveaxis(ranks, i, -1).reshape(-1, axis_sizes[i]):
            line = [int(r) for r in line]
            group = dist.new_group(line)
            if rank in line:
                groups[axis] = group
    return ReceiverMesh(axis_sizes, rank, groups)


# ---- collectives over one axis of the mesh ----------------------------------

# calls, wall seconds (on the host) and host copies of the collectives of
# this process; gloo moves CPU tensors only, so a CUDA tensor goes through
# host memory, one copy each way. A replay of a captured step adds the
# calls its capture recorded; the seconds count eager calls only (a replay
# runs no Python), and a captured step has no host copy (NCCL only)
COLLECTIVES = {"calls": 0, "seconds": 0.0, "host_copies": 0}
graphs.register_counter(COLLECTIVES, ("calls",))


def reset_collectives():
    COLLECTIVES.update(calls=0, seconds=0.0, host_copies=0)


@contextmanager
def _counted():
    t0 = time.perf_counter()
    try:
        yield
    finally:
        COLLECTIVES["calls"] += 1
        COLLECTIVES["seconds"] += time.perf_counter() - t0


def mesh_cuda_graph(mesh, cuda_graph):
    """cuda_graph (``utils/graphs.py``) as a step on `mesh` may take it: a
    mesh whose collectives run over gloo stays eager (its CUDA tensors go
    through host memory, ``_to_wire``, which a graph cannot hold), and
    True raises ValueError there; NCCL's collectives are captured with the
    step, and a mesh without a process group has none."""
    if mesh is None or mesh.groups is None:
        return cuda_graph
    backend = dist.get_backend(mesh.group("time"))
    if backend == "gloo":
        if cuda_graph:
            raise ValueError(
                "cuda_graph=True on a mesh over gloo: gloo moves a CUDA "
                "tensor through host memory, which a CUDA graph cannot hold; "
                "capture needs NCCL")
        return False
    return cuda_graph


# the captured programs whose graphs hold collectives of a process group.
# NCCL does not take a communicator down while a graph that uses it lives
# (destroy_process_group waits for ever), so distributed.shutdown() frees
# their graphs first (release_collective_programs)
_COLLECTIVE_PROGRAMS = weakref.WeakSet()


def track_collectives(program, mesh):
    """Note `program` (made for `mesh`) if it is captured with the mesh's
    collectives inside; returns it."""
    if getattr(program, "captured", False) and mesh is not None \
            and mesh.groups is not None:
        _COLLECTIVE_PROGRAMS.add(program)
    return program


def release_collective_programs():
    """Free the graphs of every captured program that holds collectives;
    each captures again at its next call."""
    for program in list(_COLLECTIVE_PROGRAMS):
        if program.device.type == "cuda":
            torch.cuda.synchronize(program.device)
        program.release()


def _to_wire(x: torch.Tensor, group) -> torch.Tensor:
    """x as the group's backend takes it: under gloo a CUDA tensor is
    copied to the host."""
    if x.is_complex():
        x = torch.view_as_real(x)
    if x.is_cuda and dist.get_backend(group) == "gloo":
        COLLECTIVES["host_copies"] += 1
        return x.cpu()
    return x.contiguous()


def _from_wire(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if x.device != like.device:
        COLLECTIVES["host_copies"] += 1
        x = x.to(like.device)
    return torch.view_as_complex(x) if like.is_complex() else x


def _all_gather(mesh: ReceiverMesh, axis: str, x: torch.Tensor):
    """(n, *x.shape): x of every rank on this rank's line along `axis`, in
    the order of their coordinates."""
    group = mesh.group(axis)
    if group is None:
        return x[None]
    with _counted():
        w = _to_wire(x, group)
        parts = [torch.empty_like(w) for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, w, group=group)
        return _from_wire(torch.stack(parts), x)


def _all_reduce(mesh: ReceiverMesh, axis: str, x: torch.Tensor, op):
    """x reduced by op over this rank's line along `axis` (a new tensor)."""
    group = mesh.group(axis)
    if group is None:
        return x
    with _counted():
        w = _to_wire(x, group).clone()
        dist.all_reduce(w, op, group=group)
        return _from_wire(w, x)


def _halo_from_right(mesh: ReceiverMesh, head: torch.Tensor,
                     tail: torch.Tensor) -> torch.Tensor:
    """The samples that follow this rank's block: the head of the right
    neighbour's block along 'time', or `tail` (what follows the whole
    block) on the last time rank. Each rank but the first sends its head
    to its left neighbour."""
    n, t = mesh.shape["time"], mesh.coords["time"]
    if n == 1:
        return tail
    group = mesh.group("time")
    with _counted():
        send = _to_wire(head, group)
        recv = torch.empty_like(send)
        ops = []
        if t > 0:
            ops.append(dist.P2POp(dist.isend, send,
                                  dist.get_global_rank(group, t - 1), group))
        if t < n - 1:
            ops.append(dist.P2POp(dist.irecv, recv,
                                  dist.get_global_rank(group, t + 1), group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return tail if t == n - 1 else _from_wire(recv, head)


def make_timesharded_demod(demod: OFDMDemodulator, frames_per_shard: int,
                           block_tracking: bool = False, *, mesh=None,
                           cuda_graph=None):
    """Streaming demod of ``frames_per_shard`` frames a call for B streams.

    Input iq: (B, T) complex64 with T = frames_per_shard * frame_samples,
    aligned so that frame f starts at f * frame_samples. Every frame's
    window is read at that fixed grid from [iq ‖ tail]; ``tail`` is the
    (B, halo) samples that FOLLOW the block in the stream (the next block's
    head), which the last frame's timing margin reads. With a zero tail
    (``None``: end of stream) a positive fine-time offset would make the
    last frame of every block read zeros. Returns fn(carry, iq, tail) ->
    (carry, bits (B, 1, F, nb_frame_bits) int8, offsets (B, 1, F) int32).
    The carry's fields have leading dims (B, 1), the 1 being this rank's
    place on the time axis. The offsets are each frame's measured fine-time
    offset, 0 for a frame that lost sync (a noise burst must not move the
    host's read grid): the serving loop advances its read position by them
    (``FusedFleet.drift_correction``).

    With a mesh whose 'time' axis is n > 1, the stream's block of n * T
    samples is split over the n time ranks: each passes its own T samples,
    takes its halo from its right neighbour, and keeps a carry of its own
    (each time shard tracks its own sync). Only the last time rank reads
    ``tail``.

    block_tracking=True demodulates all frames as ONE batch from the sync
    state at the block's start, and advances the carry once, from the last
    frame's estimates: B * F windows a call instead of B, for a tracking
    loop F times slower, which is fine in locked steady state. The
    sequential scan is the exact default.

    cuda_graph: None returns on a CUDA device fn as a
    ``utils.graphs.CapturedProgram`` (a graph for each shape, a tail of
    None its own; outputs valid until its next call), the halo's send/recv
    inside it when the mesh runs over NCCL; over gloo, and on the CPU, the
    plain function (``mesh_cuda_graph``). True asks for the capture, False
    returns the plain function."""
    fs = demod.params.nb_frame_samples
    win = demod.window_len
    halo = win - fs
    f_loc = frames_per_shard

    def run(carry: DemodCarry, iq: torch.Tensor, tail=None):
        B = iq.shape[0]
        if tail is None:
            tail = torch.zeros((B, halo), dtype=iq.dtype, device=iq.device)
        if mesh is not None:
            tail = _halo_from_right(mesh, iq[:, :halo], tail)
        ext = torch.cat([iq, tail], dim=1)
        c = DemodCarry(*[x[:, 0] for x in carry])
        if block_tracking:
            wins = ext.unfold(1, win, fs).reshape(B * f_loc, win)
            c_rep = DemodCarry(*[x[:, None].expand(B, f_loc).reshape(-1)
                                 for x in c])
            c_out, out = demod._frame_step_impl(c_rep, wins)
            bits = out["bits"].reshape(B, f_loc, -1)
            offs = torch.where(out["sync_ok"], out["offset"], 0
                               ).reshape(B, f_loc)
            c = DemodCarry(*[x.reshape(B, f_loc)[:, -1] for x in c_out])
        else:
            bits, offs = [], []
            for f in range(f_loc):
                c, out = demod._frame_step_impl(
                    c, ext[:, f * fs:f * fs + win])
                bits.append(out["bits"])
                offs.append(torch.where(out["sync_ok"], out["offset"], 0))
            bits = torch.stack(bits, dim=1)            # (B, f_loc, nbits)
            offs = torch.stack(offs, dim=1)            # (B, f_loc)
        carry = DemodCarry(*[x[:, None] for x in c])
        return carry, bits[:, None], offs[:, None].to(torch.int32)

    return _program_of(run, demod.device, mesh, cuda_graph, halo=halo)


def _program_of(fn, device, mesh, cuda_graph, **meta):
    """fn, or fn as a captured program when cuda_graph and the mesh allow
    it on `device` (``mesh_cuda_graph``), with the attributes `meta`."""
    if use_graph(mesh_cuda_graph(mesh, cuda_graph), device):
        fn = track_collectives(CapturedProgram(fn, device, cuda_graph=True),
                               mesh)
    for k, v in meta.items():
        setattr(fn, k, v)
    return fn


def shard_demod_batch(demod: OFDMDemodulator, mesh: ReceiverMesh,
                      batch: int):
    """The batched frame step for this rank's rows of a batch split over
    every rank of the mesh (the flat ('ens', 'time', 'sub') order, rank r
    owning the r-th of mesh.size equal blocks). Returns (step, (lo, hi)):
    step(carry, windows) -> (carry, {bits, sync_ok, offset}) for carry
    fields (hi - lo,) and windows (hi - lo, window_len) complex64, and the
    global rows [lo, hi) of this rank."""
    if batch % mesh.size:
        raise ValueError(f"a batch of {batch} does not split over "
                         f"{mesh.size} ranks")
    n = batch // mesh.size
    return demod.frame_step_batch, (mesh.rank * n, (mesh.rank + 1) * n)


def _digest(*xs) -> torch.Tensor:
    """One float32 scalar that depends on every element of every tensor: a
    caller that fetches it has waited for the whole prefix."""
    return sum((torch.view_as_real(x) if x.is_complex() else x)
               .to(torch.float32).sum() for x in xs)


def common_trellis_steps(max_steps: int) -> int:
    """The round's common trellis length, 6 + 24k steps and at least
    max_steps: the data bits stay a whole number of bytes for the packing on
    the device (and the step count divides by 2 and 3, which the JAX
    package's radix-4 and radix-8 scans need; the same length keeps both
    packages' path errors comparable)."""
    return 6 + 24 * ((max_steps - 6 + 23) // 24)


class MSCLanes:
    """The subchannel lanes' padded depuncture and descramble, as the round
    runs them. spec_grid holds rows of ``ops.viterbi.ViterbiSpec``, one row
    shared by every stream or one a stream, a spec a subchannel; every lane
    is padded to the common trellis of nb_steps steps. Each lane's
    depuncture gather has a 3-state mask: 1 = transmitted symbol
    (gathered), 0 = punctured (metric-neutral 0), -1 = trellis pad (a
    strong zero bit keeps the survivor in state 0). The tensors are
    (rows, S, 1, n) on `device`: they broadcast over the streams and the C
    CIFs of a round."""

    def __init__(self, spec_grid, nb_steps: int, device):
        from ..ops import viterbi as vit
        from ..ops.scrambler import prbs_bits
        lead = (len(spec_grid), len(spec_grid[0]))
        g_np = np.zeros(lead + (nb_steps * 4,), np.int64)
        m_np = np.full(lead + (nb_steps * 4,), -1, np.int8)
        prbs_np = np.zeros(lead + (nb_steps - 6,), np.int8)
        for bi, row in enumerate(spec_grid):
            for si, sp in enumerate(row):
                n_mother = sp.nb_steps * 4
                g_np[bi, si, :n_mother] = sp.gather_idx
                m_np[bi, si, :n_mother] = sp.mask.astype(np.int8)
                prbs_np[bi, si, :sp.nb_data_bits] = prbs_bits(sp.nb_data_bits)
        self.gather = torch.as_tensor(g_np, device=device)[:, :, None, :]
        self.transmitted = torch.as_tensor(m_np == 1,
                                           device=device)[:, :, None, :]
        self.fill = torch.as_tensor(np.where(m_np == 0, 0, vit.SOFT_LOW)
                                    .astype(np.int8),
                                    device=device)[:, :, None, :]
        self.prbs = torch.as_tensor(prbs_np, device=device)[:, :, None, :]

    def depuncture(self, deints: torch.Tensor) -> torch.Tensor:
        """(B, S, C, nb_sub_bits) deinterleaved int8 soft bits -> (B, S, C,
        nb_steps * 4) depunctured, padded lanes."""
        B, S, C = deints.shape[:3]
        d = torch.gather(deints, -1, self.gather.expand(B, S, C, -1))
        return torch.where(self.transmitted, d, self.fill)

    def descramble(self, bits: torch.Tensor) -> torch.Tensor:
        """(B, S, C, nb_steps - 6) decoded bits -> the payload bits (energy
        dispersal undone)."""
        return bits ^ self.prbs


def receiver_step(device, *args, **kw):
    """The whole receiver round on `device`: multichip_receiver_step
    without a mesh, which takes the same arguments after the device and
    documents them. Returns (fn, example_args); fn(demod_carry,
    deint_hist, iq, tail=None) -> (demod_carry, deint_hist, outputs). On a
    CUDA device fn is the round captured as CUDA graphs (``cuda_graph``),
    the counterpart of the JAX package's jitted step."""
    return multichip_receiver_step(None, *args, device=device, **kw)


def multichip_receiver_step(mesh, transmission_mode: int = 2,
                            frames_per_shard: int = 1,
                            nb_subchannel_cu: int = 12,
                            subchannels_per_shard: int = 2,
                            ensembles_per_shard: int = 2,
                            ingest: str = "pairs",
                            subchannel_cfgs=None,
                            block_tracking: bool = False,
                            viterbi: str = "exact",
                            chainback: str = "sequential",
                            viterbi_branch: str = "matmul",
                            fuse_fic: bool = False,
                            stop_after: str = None, *, device,
                            cuda_graph=None):
    """The receiver round, IQ in, decoded bits out: on `device` alone
    with mesh None (``receiver_step``), else this rank's part of it.

    Returns (fn, example_args). fn(demod_carry, deint_hist, iq, tail=None)
    -> (demod_carry, deint_hist, outputs). iq is (B, 2 * T) uint8 for
    ingest="u8" or (B, T, 2) float32 pairs for "pairs", with
    B = ensembles_per_shard and T = frames_per_shard * frame_samples; a
    numpy array or a tensor on any device is moved to `device`. `tail` is
    the next block's first fn.tail_samples samples in the same format; omit
    it only at the end of a stream. outputs:
      fib_bits (B, F, nb_cifs, 768) descrambled FIB-group bits,
      msc_bits (B, S, F * nb_cifs, nb_data) descrambled subchannel payload
        bits (valid once the deinterleaver history holds 16 CIFs),
      fic_err, msc_err: Viterbi path errors of the FIC groups and of the
        (B, S, C) subchannel lanes,
      offsets (B, F): each frame's fine-time offset (0 when out of sync).

    subchannel_cfgs is a list of SubchannelConfig shared by every stream
    (mixed UEP / EEP-A / EEP-B allowed), or a list of B such rows, one a
    stream, for streams that monitor different ensembles. Everything is
    padded to the largest subchannel: each lane's depuncture gather has a
    3-state mask (transmitted / punctured, fed as 0 / trellis pad, fed as a
    strong zero bit) so that every trellis ends in state 0 at the common
    length 6 + 24k, and one decode covers the mix. Without subchannel_cfgs,
    subchannel s takes CUs [s * cu, (s + 1) * cu) at EEP 3-A.

    fuse_fic=True adds the FIC groups to that decode as extra lanes, each
    774-step trellis padded to the common length by strong zero bits: one
    Viterbi launch a round instead of two. Each pad step adds -508 to the
    state-0 path and the error formula adds 508 back, so fic_err is that of
    the separate decode.

    stop_after ends the round after a prefix and returns (carry,
    deint_hist, {"digest": scalar}) for timing the stages: "ingest",
    "demod", "subs" (frame regather, FIC slice, CIF slices), "deint",
    "depunct" (the Viterbi lanes), "acs" (the forward pass alone: through
    the forward kernel, or with viterbi_branch="lut" through the torch
    radix-4 loop with the LUT metrics). The state advances as far as the
    prefix reaches.

    viterbi picks the decode of the lanes: "exact" (the full trellis),
    "tiled" (overlap-save windows of 128 + 2 * 96 steps, see
    ops/viterbi.py:viterbi_decode_soft_tiled; the path errors are then
    reported as zeros, and fused FIC lanes decode tiled too, while the
    standalone FIC decode stays exact) or "radix8" (exact, three trellis
    steps a loop iteration). chainback is "sequential", "parallel" (log-depth
    map composition) or "fused" (register exchange); viterbi_branch is
    "matmul" or "lut" (the 16-entry branch metrics) and applies to every
    decode of the round. All give the same bits except "tiled", whose
    accuracy contract is its own. With chainback="sequential" and
    viterbi_branch="matmul", "exact" and "tiled" run K1 in one launch; every
    other combination, and "radix8", runs the algorithm it names as torch
    operations, far slower on a GPU (root PERF.md). radix8 goes with the
    sequential or the parallel chainback and with "matmul" only.

    cuda_graph: None (the default) returns on a CUDA device the round as a
    ``utils.graphs.CapturedProgram``, one CUDA graph for each set of input
    shapes (a ``tail`` of None is a shape of its own), as the JAX package
    jits its step; on the CPU it returns the plain function. True asks for
    the capture and raises on a CPU device, False returns the plain
    function anywhere. Every flag above is captured, ``stop_after``
    prefixes included. A captured fn copies its arguments into static
    buffers (a numpy round through pinned memory) and returns static
    buffers, valid until its next call; its outputs are bit-identical to
    the plain function's. With a mesh the round is captured with its
    collectives when they run over NCCL; over gloo it stays eager, and
    True raises ValueError (``mesh_cuda_graph``).

    With a ReceiverMesh it is this rank's part of the round over the
    ('ens', 'time', 'sub') mesh: the same body on `device`, with
    collectives around it. Every rank of the mesh builds it with the same
    arguments and calls it once a round; fn(demod_carry, deint_hist, iq,
    tail=None) -> (demod_carry, deint_hist, outputs) for this rank's shard:
      iq: the ensembles_per_shard streams of this rank's ens coordinate
        (global rows fn.rows), frames [t * F_loc, (t + 1) * F_loc) of the
        round for time coordinate t and F_loc = frames_per_shard, as u8
        (B_loc, 2 * F_loc * frame_samples) or pairs (B_loc, F_loc *
        frame_samples, 2); tail, the samples after the whole round, is read
        by the last time rank alone;
      demod_carry: fields (B_loc, 1), this time shard's own sync state;
      deint_hist: (B_loc, S_loc, 16, nb_sub_bits) for the S_loc =
        S / n_sub subchannels fn.subs of this rank;
      outputs: fib_bits (B_loc, F, nb_cifs, 768) and offsets (B_loc, F) of
        all F = n_time * F_loc frames, msc_bits (B_loc, S_loc, F * nb_cifs,
        nb_data) and the path errors fic_err (B_loc * F * nb_cifs) and
        msc_err (B_loc * S_loc * C).
    The widths (nb_sub_bits, the common trellis) are those of all S
    subchannels, as in the JAX step; fn.subchannel_cfgs and
    fn.msc_nb_data_bits describe all of them. ``gather_round`` puts the
    ranks' shards together into the JAX step's global outputs.

    The collectives: the halo of each time block comes from the right
    neighbour (send/recv in the time group), and after the demod the frames
    and offsets of the time shards are gathered (all_gather in the time
    group). Nothing crosses 'ens' or 'sub': each rank slices, deinterleaves,
    depunctures and decodes its own subchannels' lanes, through K1 in one
    launch on a CUDA device with the default flags.

    The FIC decodes on every rank of an ens group, with fuse_fic as extra
    lanes of that rank's one decode: every rank holds the group's frames
    after the gather, the FIC groups are B_loc * F * nb_cifs lanes beside
    B_loc * S_loc * C of the MSC (a few per cent at serving widths), and a
    FIC decode on one sub rank alone would need a broadcast of the FIBs
    after it and give the ranks' decodes different shapes. The JAX program
    replicates its FIC decode over 'time' and 'sub' in the same way, and
    its MSC decode over 'time', as this one does."""
    from ..ops import viterbi as vit
    from ..ops.deinterleave import (make_gather_index,
                                    deinterleave_push_block, DEPTH)
    from ..ops.scrambler import prbs_bits
    from ..kernels import viterbi_acs as k1
    from ..params import (fic_puncture_schedule, msc_puncture_schedule,
                          SubchannelConfig, get_dab_params)

    if transmission_mode == 3:
        raise NotImplementedError(
            "transmission mode III FIC (32-CU FIB groups) is unsupported: "
            "the puncture schedule is known for 2304-bit FIB groups only")
    if viterbi not in ("exact", "tiled", "radix8"):
        raise ValueError(f"viterbi must be 'exact', 'tiled' or 'radix8', "
                         f"got {viterbi!r}")
    vit._check_flags(chainback, viterbi_branch)
    if viterbi == "radix8" and chainback == "fused":
        raise ValueError("radix8 has no register-exchange (fused) chainback")
    if viterbi == "radix8" and viterbi_branch == "lut":
        raise ValueError("radix8 implements only the matmul branch route")
    if ingest not in ("u8", "pairs"):
        raise ValueError(f"ingest must be 'u8' or 'pairs', got {ingest!r}")
    if stop_after not in STOP_AFTER:
        raise ValueError(f"stop_after must be one of {STOP_AFTER}, "
                         f"got {stop_after!r}")
    graph = mesh_cuda_graph(mesh, cuda_graph)
    device = torch.device(device)
    demod = OFDMDemodulator(transmission_mode, device=device)
    dab = get_dab_params(transmission_mode)
    sizes = mesh.shape if mesh is not None else dict.fromkeys(AXES, 1)
    coord = mesh.coords if mesh is not None else dict.fromkeys(AXES, 0)
    n_ens, n_time, n_sub = (sizes[a] for a in AXES)
    B = ensembles_per_shard                          # this rank's streams
    F = n_time * frames_per_shard                    # frames a round
    C = F * dab.nb_cifs                              # CIFs a round
    demod_fn = make_timesharded_demod(demod, frames_per_shard,
                                      block_tracking=block_tracking,
                                      mesh=mesh, cuda_graph=False)

    fic_spec = vit.ViterbiSpec.from_schedule(fic_puncture_schedule())
    if subchannel_cfgs is None:
        subchannel_cfgs = [
            SubchannelConfig(s * nb_subchannel_cu, nb_subchannel_cu, False,
                             eep_type="A", eep_prot_level=2)
            for s in range(n_sub * subchannels_per_shard)]
    cfgs = list(subchannel_cfgs)
    per_stream = bool(cfgs) and isinstance(cfgs[0], (list, tuple))
    if per_stream:
        grid = [list(row) for row in cfgs]
        if len(grid) != n_ens * B or any(len(row) != len(grid[0])
                                         for row in grid):
            raise ValueError(f"per-stream cfg rows: need {n_ens * B} rows "
                             f"of one length, got {[len(row) for row in grid]}")
    else:
        grid = [cfgs]
    if len(grid[0]) % n_sub:
        raise ValueError(f"{len(grid[0])} subchannels do not split over "
                         f"{n_sub} sub ranks")
    S = len(grid[0]) // n_sub                        # this rank's subchannels
    flat = [c for row in grid for c in row]
    if any(c.start_address + c.length > dab.nb_cif_bits // 64 for c in flat):
        raise ValueError("subchannels exceed CIF capacity")
    spec_grid = [[vit.ViterbiSpec.from_schedule(msc_puncture_schedule(c))
                  for c in row] for row in grid]
    # the padded widths are those of the whole mesh's subchannels, so that
    # every rank's lanes, history and outputs have one shape
    nb_sub_bits = max(c.nb_cif_bits for c in flat)   # padded common width
    max_steps = max(sp.nb_steps for row in spec_grid for sp in row)
    if fuse_fic:
        max_steps = max(max_steps, fic_spec.nb_steps)
    nb_steps = common_trellis_steps(max_steps)
    nb_data = nb_steps - 6
    nb_data_list = [[sp.nb_data_bits for sp in row] for row in spec_grid]
    if not per_stream:
        nb_data_list = nb_data_list[0]
    # this rank's rows and subchannels of the grid
    row_range = (coord["ens"] * B, (coord["ens"] + 1) * B)
    sub_range = (coord["sub"] * S, (coord["sub"] + 1) * S)
    mine = [row[slice(*sub_range)]
            for row in (grid[slice(*row_range)] if per_stream else grid)]
    spec_grid = [row[slice(*sub_range)]
                 for row in (spec_grid[slice(*row_range)] if per_stream
                             else spec_grid)]

    lanes_plan = MSCLanes(spec_grid, nb_steps, device)
    fic_prbs = torch.as_tensor(prbs_bits(fic_spec.nb_data_bits)
                               .astype(np.int8), device=device)
    deint_idx = torch.as_tensor(make_gather_index(nb_sub_bits),
                                dtype=torch.int64, device=device)
    if per_stream:
        # each (stream, subchannel)'s CIF slice as one padded gather: the
        # index is clamped into the CIF and what lies past a subchannel's
        # own length is zeroed
        starts = np.array([[c.start_address * 64 for c in row]
                           for row in mine])                     # (B, S)
        lens = np.array([[c.nb_cif_bits for c in row] for row in mine])
        j = np.arange(nb_sub_bits)
        sub_idx = torch.as_tensor(
            np.minimum(starts[..., None] + j, dab.nb_cif_bits - 1),
            dtype=torch.int64, device=device)[:, :, None, :]  # (B, S, 1, n)
        sub_valid = torch.as_tensor(j[None, None, :] < lens[..., None],
                                    device=device)[:, :, None, :]
    L_msc = B * S * C
    L_fic = B * F * dab.nb_cifs

    def step(carry, deint_hist, iq, tail=None):
        iq = to_device(iq, device)
        if tail is not None:
            tail = to_device(tail, device)
        if ingest == "u8":
            iq = _u8_to_complex(iq)
            if tail is not None:
                tail = _u8_to_complex(tail)
        else:
            iq = _pairs_to_complex(iq)
            if tail is not None:
                tail = _pairs_to_complex(tail)
        if stop_after == "ingest":
            return carry, deint_hist, {"digest": _digest(iq)}
        carry, bits, offs = demod_fn(carry, iq, tail)
        if stop_after == "demod":
            return carry, deint_hist, {"digest": _digest(bits, offs)}
        if mesh is not None:
            # every time shard's frames, in stream order
            bits = _all_gather(mesh, "time", bits[:, 0]).transpose(0, 1)
            offs = _all_gather(mesh, "time", offs[:, 0]).transpose(0, 1)
        frames = bits.reshape(B, F, dab.nb_frame_bits)

        # ---- FIC ----
        fic_soft = frames[:, :, :dab.nb_fic_bits].reshape(L_fic,
                                                          fic_spec.nb_in)
        fib_bits = fic_err = None
        if not fuse_fic:
            fib_bits, fic_err = vit.viterbi_decode(
                fic_soft, fic_spec, chainback=chainback,
                branch=viterbi_branch)
            fib_bits = (fib_bits ^ fic_prbs).reshape(
                B, F, dab.nb_cifs, fic_spec.nb_data_bits)

        # ---- MSC: per-subchannel CIF slices (B, S, C, nb_sub_bits) ----
        cifs = frames[:, :, dab.nb_fic_bits:].reshape(B, C, dab.nb_cif_bits)
        if per_stream:
            subs = torch.gather(
                cifs[:, None].expand(B, S, C, dab.nb_cif_bits), -1,
                sub_idx.expand(B, S, C, nb_sub_bits))
            subs = torch.where(sub_valid, subs, 0)
        else:
            subs = torch.zeros((B, S, C, nb_sub_bits), dtype=torch.int8,
                               device=device)
            for s, cfg in enumerate(mine[0]):
                lo = cfg.start_address * 64
                subs[:, s, :, :cfg.nb_cif_bits] = \
                    cifs[:, :, lo:lo + cfg.nb_cif_bits]
        if stop_after == "subs":
            return carry, deint_hist, {"digest": _digest(subs, fic_soft)}

        deint_hist, deints = deinterleave_push_block(deint_hist, subs,
                                                     deint_idx)
        if stop_after == "deint":
            return carry, deint_hist, {"digest": _digest(deints)}

        # ---- the Viterbi lanes: (B, S, C) MSC lanes first, then the FIC
        # groups, in one contiguous int8 tensor as K1 takes it ----
        lanes = torch.empty((L_msc + (L_fic if fuse_fic else 0), nb_steps, 4),
                            dtype=torch.int8, device=device)
        lanes[:L_msc] = lanes_plan.depuncture(deints).reshape(
            L_msc, nb_steps, 4)
        if fuse_fic:
            lanes[L_msc:, :fic_spec.nb_steps] = vit.depuncture(
                fic_soft, fic_spec, dtype=torch.int8)
            lanes[L_msc:, fic_spec.nb_steps:].fill_(vit.SOFT_LOW)
        if stop_after == "depunct":
            return carry, deint_hist, {"digest": _digest(lanes)}
        if stop_after == "acs":
            if viterbi_branch == "matmul":
                dec, metrics = k1.viterbi_acs(lanes)      # metrics: the err
            else:
                metrics, dec = vit._radix4_forward_sm(
                    vit._start_sm(lanes.shape[0], 0, device),
                    vit._steps_sm(lanes, 2), branch=viterbi_branch)
            return carry, deint_hist, {"digest": _digest(dec, metrics)}

        if viterbi == "tiled":
            bits_full, _ = vit.viterbi_decode_soft_tiled(
                lanes, chainback=chainback, branch=viterbi_branch)
            err_full = torch.zeros((lanes.shape[0],), dtype=torch.int32,
                                   device=device)
        elif viterbi == "radix8":
            bits_full, err_full = vit.viterbi_decode_soft_radix8(
                lanes, chainback=chainback)
        else:
            bits_full, err_full = vit.viterbi_decode_soft_radix4(
                lanes, chainback=chainback, branch=viterbi_branch)
        if fuse_fic:
            fib_bits = (bits_full[L_msc:, :fic_spec.nb_data_bits]
                        ^ fic_prbs).reshape(B, F, dab.nb_cifs,
                                            fic_spec.nb_data_bits)
            fic_err = err_full[L_msc:]
        msc_bits = lanes_plan.descramble(
            bits_full[:L_msc, :nb_data].reshape(B, S, C, nb_data))
        return carry, deint_hist, {
            "fib_bits": fib_bits, "msc_bits": msc_bits,
            "fic_err": fic_err, "msc_err": err_full[:L_msc],
            "offsets": offs.reshape(B, F),
        }

    T = frames_per_shard * demod.params.nb_frame_samples
    if ingest == "u8":
        iq = torch.full((B, 2 * T), 127, dtype=torch.uint8, device=device)
    else:
        iq = torch.zeros((B, T, 2), dtype=torch.float32, device=device)
    carry = DemodCarry.init((B, 1), device=device)._replace(
        signal_l1_avg=torch.full((B, 1), 0.5, dtype=torch.float32,
                                 device=device))
    deint_hist = torch.zeros((B, S, DEPTH, nb_sub_bits), dtype=torch.int8,
                             device=device)
    # metadata for the consumers: the subchannels and their payload bits per
    # (stream,) sub; `tail_samples`, the next block's first samples to pass
    # as `tail` so that the last frame's timing margin reads real data; the
    # global stream rows and subchannels this rank decodes
    fn = _program_of(step, device, mesh, graph,
                     subchannel_cfgs=grid if per_stream else cfgs,
                     per_stream=per_stream, msc_nb_data_bits=nb_data_list,
                     tail_samples=demod_fn.halo, stop_after=stop_after,
                     rows=row_range, subs=sub_range)
    return fn, (carry, deint_hist, iq)


def _gather_objects(mesh: ReceiverMesh, obj, dst: int):
    """[obj of every rank] on rank dst, None elsewhere."""
    if mesh.groups is None:
        return [obj]
    parts = [None] * mesh.size if mesh.rank == dst else None
    with _counted():
        dist.gather_object(obj, parts, dst=dst)
    return parts


def gather_round(mesh: ReceiverMesh, carry, deint_hist, outputs,
                 dst: int = 0):
    """The mesh step's state and outputs of one round put together on rank
    dst, as numpy, in the global shapes of the JAX step: carry fields
    (B, n_time), deint_hist (B, S, 16, nb_sub_bits), fib_bits, msc_bits,
    fic_err, msc_err and offsets over all B streams and S subchannels (the
    time- and sub-replicated parts taken from time 0 and sub 0). Every rank
    calls it; it returns None on the others. For tests and checks: the
    serving path never forms the global copy."""
    def host(x):
        return x.detach().cpu().numpy()
    mine = {"at": tuple(mesh.coords[a] for a in AXES),
            "carry": [host(x) for x in carry], "hist": host(deint_hist),
            "out": {k: host(v) for k, v in outputs.items()}}
    parts = _gather_objects(mesh, mine, dst)
    if parts is None:
        return None
    by = {p["at"]: p for p in parts}
    n_ens, n_time, n_sub = mesh.axis_sizes

    def along(get, axis, n):
        """get(e, i) of every e, joined along axis over i < n, then along
        the rows over e."""
        return np.concatenate([np.concatenate([get(e, i) for i in range(n)],
                                              axis=axis)
                               for e in range(n_ens)])
    carry = [along(lambda e, t: by[(e, t, 0)]["carry"][k], 1, n_time)
             for k in range(len(mine["carry"]))]
    hist = along(lambda e, s: by[(e, 0, s)]["hist"], 1, n_sub)
    out = {}
    for k in mine["out"]:
        if k in ("msc_bits", "msc_err"):
            def sub_part(e, s, k=k):
                o = by[(e, 0, s)]["out"]
                return o[k].reshape(o["msc_bits"].shape[:3] + (-1,))
            out[k] = along(sub_part, 1, n_sub)
            if k == "msc_err":
                out[k] = out[k].reshape(-1)
        else:
            out[k] = np.concatenate([by[(e, 0, 0)]["out"][k]
                                     for e in range(n_ens)])
    return DemodCarry(*carry), hist, out


def make_coldstart_timesharded_demod(demod: OFDMDemodulator,
                                     mesh: ReceiverMesh,
                                     frames_per_shard: int, *,
                                     cuda_graph=None):
    """Sequence-parallel demod that ACQUIRES from a cold carry.

    Input iq: this rank's (B, frames_per_shard * frame_samples) complex64
    block of a stream split over the mesh's time ranks, at an arbitrary
    frame phase. Each time rank runs the null-dip search over its block,
    against the mean signal level of all blocks (a sum over 'time', then a
    divide); the earliest detection of all blocks is elected (a MIN over
    'time'), and every rank then demodulates the frames that start inside
    its block at that phase, from a halo of window_len samples from its
    right neighbour (the last rank reads `tail`, the samples after the
    whole stream block). Returns fn(iq, tail=None) -> (carry (B, 1),
    bits (B, 1, frames_per_shard, nb_frame_bits), valid (B, 1,
    frames_per_shard)); valid is False for frames before the detection,
    after a desync and on blocks with no signal. cuda_graph: as for
    make_timesharded_demod, the all-reduces and the halo inside the graph
    over NCCL."""
    p = demod.params
    fs = p.nb_frame_samples
    f_loc = frames_per_shard
    T_loc = f_loc * fs
    halo = demod.window_len
    rewind = 2 * demod.cfg.null_search_nb_samples
    big = 2 ** 30
    base = mesh.coords["time"] * T_loc

    def run(iq, tail=None):
        iq = demod._as_iq(iq)
        B = iq.shape[0]
        if tail is None:
            tail = torch.zeros((B, halo), dtype=iq.dtype, device=iq.device)
        ext = torch.cat([iq, _halo_from_right(mesh, iq[:, :halo],
                                              demod._as_iq(tail))], dim=1)
        # the mean level of all blocks: a sum, then a divide (gloo has no AVG)
        l1 = _all_reduce(mesh, "time", sync_ops.l1_average(iq),
                         dist.ReduceOp.SUM) / mesh.shape["time"]
        found, end_idx = demod._acquire_impl(l1, iq)
        cand = torch.where(found, base + end_idx, big).to(torch.int32)
        global_end = _all_reduce(mesh, "time", cand, dist.ReduceOp.MIN)
        ok = global_end < big
        null_start = torch.clamp(global_end - p.nb_null_period - rewind,
                                 min=0).to(torch.int64)
        # the first frame start inside this block, at the elected phase
        local0 = torch.where(null_start >= base, null_start - base,
                             (fs - (base - null_start) % fs) % fs)
        in_range = local0 < T_loc          # a block wholly before: none
        pos = torch.clamp(local0, max=T_loc - 1)
        carry = DemodCarry.init((B,), device=iq.device)._replace(
            signal_l1_avg=l1)
        alive = torch.ones_like(ok)
        win_ar = torch.arange(demod.window_len, device=iq.device)
        bits, valid = [], []
        for _ in range(f_loc):
            win = torch.gather(ext, 1, pos[:, None] + win_ar)
            new_c, out = demod._frame_step_impl(carry, win)
            started = (base + pos) >= null_start
            okf = out["sync_ok"] & alive & ok & started & in_range
            carry = _select(started & alive, new_c, carry)
            pos = torch.where(okf, pos + out["offset"] + fs,
                              torch.where(started, pos, pos + fs))
            pos = torch.clamp(pos, 0, T_loc - 1)
            alive = torch.where(started, okf, alive)
            bits.append(out["bits"])
            valid.append(okf)
        carry = DemodCarry(*[x[:, None] for x in carry])
        return (carry, torch.stack(bits, dim=1)[:, None],
                torch.stack(valid, dim=1)[:, None])

    return _program_of(run, demod.device, mesh, cuda_graph, halo=halo)
