"""The fused receiver round on one device (port of
``dab_radio_tpu/parallel/mesh.py``: ``make_timesharded_demod`` and
``multichip_receiver_step``, with every mesh axis of size 1).

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
are torch loops over the trellis (``ops/viterbi.py``). The mesh
version over several GPUs (``multichip_receiver_step``, the 'ens', 'time'
and 'sub' axes) is not ported yet.
"""

import numpy as np
import torch

from ..models.demodulator import OFDMDemodulator, DemodCarry
from ..utils.backend import to_device

STOP_AFTER = (None, "ingest", "demod", "subs", "deint", "depunct", "acs")


def _u8_to_complex(u8: torch.Tensor) -> torch.Tensor:
    """(B, 2n) interleaved uint8 IQ -> (B, n) complex64. The scale is a
    multiply by the float32 reciprocal, as the JAX step forms it: a divide
    differs from it by an ulp on some codes."""
    f = (u8.to(torch.float32) - 127.5) * np.float32(1.0 / 127.5)
    return torch.view_as_complex(f.reshape(u8.shape[0], -1, 2))


def _pairs_to_complex(x: torch.Tensor) -> torch.Tensor:
    """(B, n, 2) float32 IQ pairs -> (B, n) complex64."""
    return torch.view_as_complex(x.to(torch.float32).contiguous())


def make_timesharded_demod(demod: OFDMDemodulator, frames_per_shard: int,
                           block_tracking: bool = False):
    """Streaming demod of ``frames_per_shard`` frames a call for B streams.

    Input iq: (B, T) complex64 with T = frames_per_shard * frame_samples,
    aligned so that frame f starts at f * frame_samples. Every frame's
    window is read at that fixed grid from [iq ‖ tail]; ``tail`` is the
    (B, halo) samples that FOLLOW the block in the stream (the next block's
    head), which the last frame's timing margin reads. With a zero tail
    (``None``: end of stream) a positive fine-time offset would make the
    last frame of every block read zeros. Returns fn(carry, iq, tail) ->
    (carry, bits (B, 1, F, nb_frame_bits) int8, offsets (B, 1, F) int32).
    The carry's fields have leading dims (B, 1), the 1 being the time axis
    a mesh would shard. The offsets are each frame's measured fine-time
    offset, 0 for a frame that lost sync (a noise burst must not move the
    host's read grid): the serving loop advances its read position by them
    (``FusedFleet.drift_correction``).

    block_tracking=True demodulates all frames as ONE batch from the sync
    state at the block's start, and advances the carry once, from the last
    frame's estimates: B * F windows a call instead of B, for a tracking
    loop F times slower, which is fine in locked steady state. The
    sequential scan is the exact default."""
    fs = demod.params.nb_frame_samples
    win = demod.window_len
    halo = win - fs
    f_loc = frames_per_shard

    def run(carry: DemodCarry, iq: torch.Tensor, tail=None):
        B = iq.shape[0]
        if tail is None:
            tail = torch.zeros((B, halo), dtype=iq.dtype, device=iq.device)
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

    run.halo = halo
    return run


def _digest(*xs) -> torch.Tensor:
    """One float32 scalar that depends on every element of every tensor: a
    caller that fetches it has waited for the whole prefix."""
    return sum((torch.view_as_real(x) if x.is_complex() else x)
               .to(torch.float32).sum() for x in xs)


def receiver_step(device, transmission_mode: int = 2,
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
                  stop_after: str = None):
    """The whole receiver round on `device`: IQ in, decoded bits out.

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
    sequential or the parallel chainback and with "matmul" only."""
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
    device = torch.device(device)
    demod = OFDMDemodulator(transmission_mode, device=device)
    dab = get_dab_params(transmission_mode)
    B = ensembles_per_shard
    F = frames_per_shard
    C = F * dab.nb_cifs                              # CIFs a round
    demod_fn = make_timesharded_demod(demod, F, block_tracking=block_tracking)

    fic_spec = vit.ViterbiSpec.from_schedule(fic_puncture_schedule())
    if subchannel_cfgs is None:
        subchannel_cfgs = [
            SubchannelConfig(s * nb_subchannel_cu, nb_subchannel_cu, False,
                             eep_type="A", eep_prot_level=2)
            for s in range(subchannels_per_shard)]
    cfgs = list(subchannel_cfgs)
    per_stream = bool(cfgs) and isinstance(cfgs[0], (list, tuple))
    if per_stream:
        grid = [list(row) for row in cfgs]
        if len(grid) != B or any(len(row) != len(grid[0]) for row in grid):
            raise ValueError(f"per-stream cfg rows: need {B} rows of one "
                             f"length, got {[len(row) for row in grid]}")
    else:
        grid = [cfgs]
    S = len(grid[0])
    flat = [c for row in grid for c in row]
    if any(c.start_address + c.length > dab.nb_cif_bits // 64 for c in flat):
        raise ValueError("subchannels exceed CIF capacity")
    spec_grid = [[vit.ViterbiSpec.from_schedule(msc_puncture_schedule(c))
                  for c in row] for row in grid]
    nb_sub_bits = max(c.nb_cif_bits for c in flat)   # padded common width
    # common trellis length 6 + 24k: the data bits stay a whole number of
    # bytes for the packing on the device (and the step count divides by 2
    # and 3, which the JAX package's radix-4 and radix-8 scans need; the
    # same length keeps both packages' path errors comparable)
    max_steps = max(sp.nb_steps for row in spec_grid for sp in row)
    if fuse_fic:
        max_steps = max(max_steps, fic_spec.nb_steps)
    nb_steps = 6 + 24 * ((max_steps - 6 + 23) // 24)
    nb_data = nb_steps - 6

    # padded depuncture plan, leading dims (S,) shared or (B, S) per stream:
    # mask 1 = transmitted symbol (gathered), 0 = punctured (metric-neutral
    # 0), -1 = trellis pad (strong zero bit keeps the survivor in state 0)
    lead = (B, S) if per_stream else (S,)
    g_np = np.zeros(lead + (nb_steps * 4,), np.int64)
    m_np = np.full(lead + (nb_steps * 4,), -1, np.int8)
    prbs_np = np.zeros(lead + (nb_data,), np.int8)
    for bi, row in enumerate(spec_grid):
        for si, sp in enumerate(row):
            at = (bi, si) if per_stream else (si,)
            n_mother = sp.nb_steps * 4
            g_np[at][:n_mother] = sp.gather_idx
            m_np[at][:n_mother] = sp.mask.astype(np.int8)
            prbs_np[at][:sp.nb_data_bits] = prbs_bits(sp.nb_data_bits)
    if not per_stream:
        g_np, m_np, prbs_np = g_np[None], m_np[None], prbs_np[None]
    # (B or 1, S, 1, n): broadcast over the streams and the C CIFs
    gather_all = torch.as_tensor(g_np, device=device)[:, :, None, :]
    transmitted = torch.as_tensor(m_np == 1, device=device)[:, :, None, :]
    fill = torch.as_tensor(np.where(m_np == 0, 0, vit.SOFT_LOW)
                           .astype(np.int8), device=device)[:, :, None, :]
    msc_prbs = torch.as_tensor(prbs_np, device=device)[:, :, None, :]
    nb_data_list = [[sp.nb_data_bits for sp in row] for row in spec_grid]
    if not per_stream:
        nb_data_list = nb_data_list[0]
    fic_prbs = torch.as_tensor(prbs_bits(fic_spec.nb_data_bits)
                               .astype(np.int8), device=device)
    deint_idx = torch.as_tensor(make_gather_index(nb_sub_bits),
                                dtype=torch.int64, device=device)
    if per_stream:
        # each (stream, subchannel)'s CIF slice as one padded gather: the
        # index is clamped into the CIF and what lies past a subchannel's
        # own length is zeroed
        starts = np.array([[c.start_address * 64 for c in row]
                           for row in grid])                     # (B, S)
        lens = np.array([[c.nb_cif_bits for c in row] for row in grid])
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
            for s, cfg in enumerate(cfgs):
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
        d = torch.gather(deints, -1,
                         gather_all.expand(B, S, C, nb_steps * 4))
        lanes[:L_msc] = torch.where(transmitted, d, fill).reshape(
            L_msc, nb_steps, 4)
        if fuse_fic:
            lanes[L_msc:, :fic_spec.nb_steps] = vit.depuncture(
                fic_soft, fic_spec, dtype=torch.int8)
            lanes[L_msc:, fic_spec.nb_steps:] = vit.SOFT_LOW
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
        msc_bits = bits_full[:L_msc, :nb_data].reshape(B, S, C, nb_data) \
            ^ msc_prbs
        return carry, deint_hist, {
            "fib_bits": fib_bits, "msc_bits": msc_bits,
            "fic_err": fic_err, "msc_err": err_full[:L_msc],
            "offsets": offs.reshape(B, F),
        }

    T = F * demod.params.nb_frame_samples
    if ingest == "u8":
        iq = torch.full((B, 2 * T), 127, dtype=torch.uint8, device=device)
    else:
        iq = torch.zeros((B, T, 2), dtype=torch.float32, device=device)
    carry = DemodCarry.init((B, 1), device=device)._replace(
        signal_l1_avg=torch.full((B, 1), 0.5, dtype=torch.float32,
                                 device=device))
    deint_hist = torch.zeros((B, S, DEPTH, nb_sub_bits), dtype=torch.int8,
                             device=device)
    step.subchannel_cfgs = grid if per_stream else cfgs   # consumer metadata
    step.per_stream = per_stream
    step.msc_nb_data_bits = nb_data_list   # payload bits per (stream,) sub
    # pass the next block's first `tail_samples` samples as `tail`, so that
    # the last frame's timing margin reads real data
    step.tail_samples = demod_fn.halo
    step.stop_after = stop_after
    return step, (carry, deint_hist, iq)
