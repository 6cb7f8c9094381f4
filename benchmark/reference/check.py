"""The comparison that decides `correct`: what the timed path produced,
against what was sent and against the plain reference.

Numbers compared, each with its limit (a cell's "check" block):
- au_errors: units due in the window that never came, plus any unit that
  came with other bytes, at another index, twice, or out of place. Exact:
  limit 0. A unit is a DAB+ access unit, or a classic DAB service's MP2
  frame, which counts here under the same rules: one unit (index 0) a
  group of one logical frame. A unit is due when the last CIF of its
  group's last logical frame (a superframe's fifth, the MP2 frame's own)
  has reached the program, plus 15 CIFs of time interleaving; it may come
  late (with the deferred round, or the flush after the window), not
  wrong. The first 15 MP2 frames of each stream and subchannel are not
  judged: a stream's time deinterleaver starts cold and holds none of
  their earlier CIFs' bits, and an MP2 frame has no check by which the
  program could hold them back (a DAB+ superframe has its firecode).
- db_errors: fields of the ensemble database decoded from the FIBs (the
  ensemble's id and label; each service's id, label and component; each
  subchannel's address, size and protection: EEP's type and level, or
  UEP's table index) that differ from what the FIGs sent, and entries that
  were not sent. Exact: limit 0.
- lost_sync: frames that lost sync (the demodulator's own count), rounds of
  a stream whose FIBs did not all pass their CRC, frames of the stream the
  tuner never yielded, and fleet streams whose read grid (the frame start
  the program aligned them to) is not the frame start that the reference
  finds in the same capture. Exact: limit 0.
- freq_gap_bins: the widest gap, over the streams, between the program's
  carrier offsets (freq_coarse, freq_fine) after its last frame and the
  reference's after the same frame, in carrier spacings.
- l1_gap: the widest relative gap of the running signal level.
- softbit_gap (tuner): the widest gap of a soft bit, over the sampled
  frames of the window, against the reference's soft bits of that frame.
The reference follows each stream over its last `reference_frames` frames
from a cold start (the carry forgets its start by 0.95 a frame), finding
the frames' timing, carrier offset and level itself. A fleet's streams are
read on the grid the program aligned them to, as the serving round reads
them; the reference finds each capture's first frame itself, and a grid
that is not on it counts as lost sync.

`correct` is verdict(): every number at or under its limit.
"""

import numpy as np
import torch

from traffic import standard as S
from traffic import transmit as T

from .demod import Reference

INTERLEAVE_CIFS = S.DEPTH - 1
# the signal level a serving round's carry starts from (parallel/mesh.py
# documents the round's initial state)
FLEET_L1_START = 0.5


def verdict(numbers: dict, limits: dict) -> bool:
    """True when every number compared has a limit and is at or under it."""
    return all(limits.get(k) is not None and v <= limits[k]
               for k, v in numbers.items())


def _sent_index(traffic):
    """[capture][service] {unit bytes: (group, index)}."""
    return [[{au: (k, i) for k, sf in enumerate(aus)
              for i, au in enumerate(sf)} for aus in cap]
            for cap in traffic.sent]


def access_units(traffic, out: dict, unit_cifs, window: tuple) -> dict:
    """unit_cifs(stream, unit) -> (first period CIF, end) of the unit (a
    round or a frame) whose processing delivered an AU or an MP2 frame;
    window = (first, last) unit whose outputs came back inside the
    window. A fleet keeps millions of units a run, so each is looked up
    once in Python and the rest is worked out on arrays."""
    nb_cifs = S.dab_params(traffic.ensemble.mode).nb_cifs
    services = traffic.ensemble.services
    n_svc = len(services)
    period_cifs = traffic.period_frames * nb_cifs
    index = _sent_index(traffic)
    capture_of = out["capture_of"]
    recs = out["aus"]
    n = len(recs)
    # what was sent with these bytes: (group, index), None for bytes never
    # sent and for a subchannel that was not sent (s None)
    hits = [index[capture_of[b]][s].get(au) if s is not None else None
            for b, s, _, au, _ in recs]

    def col(values):
        return np.fromiter(values, np.int64, n)
    b = col(r[0] for r in recs)
    s = col(-1 if r[1] is None else r[1] for r in recs)
    i = col(r[2] for r in recs)
    unit = col(r[4] for r in recs)
    k = col(-1 if h is None else h[0] for h in hits)
    i_sent = col(-1 if h is None else h[1] for h in hits)

    # MP2 frames are judged from the 16th of their (stream, service) on,
    # counted in the order they were kept
    mp2 = np.array([svc.kind == "dab" for svc in services] + [False])[s]
    group = b * (n_svc + 1) + s + 1
    order = np.argsort(group, kind="stable")
    seen = np.empty(n, np.int64)
    seen[order] = np.arange(n) - np.searchsorted(group[order], group[order])
    judged = ~(mp2 & (seen < INTERLEAVE_CIFS))
    ok = judged & (k >= 0) & (i_sent == i)
    wrong = int(np.count_nonzero(judged & ~ok))
    b, s, i, unit, k = (x[ok] for x in (b, s, i, unit, k))

    # the CIFs of each unit's round or frame, asked once a (stream, unit)
    u0 = int(unit.min(initial=0))
    span = int(unit.max(initial=0)) - u0 + 1
    pairs, at = np.unique(b * span + unit - u0, return_inverse=True)
    cifs = np.array([unit_cifs(int(p // span), int(p % span) + u0)
                     for p in pairs], np.int64).reshape(-1, 2)
    lo, hi = cifs[at, 0], cifs[at, 1]
    L = np.array([svc.group_frames for svc in services], np.int64)[s]
    groups = np.array([traffic.groups(svc) for svc in services], np.int64)[s]
    mid = (lo + hi) / 2
    K = k + groups * np.round((mid - _due(0, L) - L * k)
                              / period_cifs).astype(np.int64)
    soon = _due(K, L) >= hi
    wrong += int(np.count_nonzero(soon))
    b, s, i, K = (x[~soon] for x in (b, s, i, K))
    # each (stream, service, group, index) once: the others came twice
    k0 = int(K.min(initial=0))
    n_k = int(K.max(initial=0)) - k0 + 1
    n_u = max(svc.group_units for svc in services)
    delivered = np.unique(((b * n_svc + s) * n_k + K - k0) * n_u + i)
    wrong += len(K) - len(delivered)

    # due: the groups whose last logical frame is whole within the window
    first = np.zeros((len(capture_of), n_svc), np.int64)
    last = np.zeros_like(first)
    attempted = 0
    for bb in range(len(capture_of)):
        w0, _ = unit_cifs(bb, window[0])
        _, w1 = unit_cifs(bb, window[1])
        for ss, svc in enumerate(services):
            Ls = svc.group_frames
            first[bb, ss] = -(-(w0 - _due(0, Ls)) // Ls)
            last[bb, ss] = (w1 - 1 - _due(0, Ls)) // Ls
            attempted += max(0, last[bb, ss] - first[bb, ss] + 1) \
                * svc.group_units
    bs, Kd = (delivered // n_u) // n_k, (delivered // n_u) % n_k + k0
    bd, sd = bs // n_svc, bs % n_svc
    came = np.count_nonzero((Kd >= first[bd, sd]) & (Kd <= last[bd, sd]))
    return {"wrong": wrong, "missing": int(attempted - came),
            "attempted": int(attempted)}


def _due(K: int, L: int = T.SUPERFRAME_FRAMES) -> int:
    """The period CIF at which group K (of L logical frames: a superframe,
    or an MP2 frame) is whole: its last logical frame out of the time
    interleaver."""
    return L * K + L - 1 + INTERLEAVE_CIFS


def database(traffic, dbs) -> int:
    ens = traffic.ensemble
    errors = 0
    for db in dbs:
        errors += db.ensemble.id != ens.ensemble_id
        errors += db.ensemble.label.strip() != ens.label.strip()
        errors += len(db.services) != len(ens.services)
        errors += len(db.subchannels) != len(ens.services)
        for svc in ens.services:
            got = db.services.get(svc.service_id)
            errors += got is None or got.label.strip() != svc.label.strip()
            sub = db.subchannels.get(svc.subchannel_id)
            want = (svc.sub.start_address, svc.sub.length, svc.sub.is_uep)
            errors += sub is None or (sub.start_address, sub.length,
                                      bool(sub.is_uep)) != want
            if sub is not None and not svc.sub.is_uep:
                errors += (sub.eep_type, sub.eep_prot_level) != (
                    svc.sub.eep_type, svc.sub.eep_prot_level)
            if sub is not None and svc.sub.is_uep:
                errors += sub.uep_table_index != svc.sub.uep_table_index
            comp = db.component_by_subchannel(svc.subchannel_id)
            errors += comp is None or comp.service_id != svc.service_id \
                or comp.audio_service_type != (63 if svc.kind == "dab+" else 0)
    return int(errors)


def _captures(traffic, device):
    return [torch.complex(*(torch.as_tensor(c[j::2], device=device)
                            .to(torch.float64).sub(127.5).div(127.5)
                            for j in (0, 1)))
            for c in traffic.captures]


def reference_numbers(traffic, out: dict, cell_check: dict, device,
                      precision: str = "f64") -> dict:
    """Run the reference (or the control, precision "bf16") over the tracks
    that end where the program's streams ended, and at the sampled frames.
    Returns {"carry": the carry after each stream's last frame, "bits":
    {k: soft bits of the k-th sampled frame}, "lost": frames out of sync
    a track, "null0": the tuner's first NULL in the capture, "align": the
    fleet's captures' first frame start and whether it synced}."""
    ref = Reference(traffic.ensemble.mode, device, precision)
    caps = _captures(traffic, device)
    fs = traffic.frame_samples
    W = cell_check["reference_frames"]
    tracks, bits_at, null0, align = [], [], None, None
    if out["kind"] == "fleet":
        align = [ref.align(c) for c in caps]
        F = out["frames_in"]
        n = min(W, F)
        for v, start in enumerate(out["start_bytes"]):
            # from the stream's start, the level starts where the serving
            # round states it does
            tracks.append({"capture": v, "frames": n, "mode": "grid",
                           "start": start // 2 + (F - n) * fs,
                           "l1": FLEET_L1_START if n == F else 0.0})
    else:
        s0 = out["start_bytes"][0] // 2
        null0 = ref.acquire(caps[0], s0)
        # the streaming demodulator starts its level at the level of the
        # block in which it found the first NULL: the stream's first window
        head = caps[0][s0:s0 + ref.window_len]
        l1_head = float((head.real.abs() + head.imag.abs()).mean())
        ends = [j for j, _ in out["sampled"]] + [out["frames"] - 1]
        for k, j in enumerate(ends):
            n = min(W, j + 1)
            tracks.append({"capture": 0, "frames": n, "mode": "tracked",
                           "start": null0 + (j + 1 - n) * fs,
                           "l1": l1_head if n == j + 1 else 0.0})
            if k < len(out["sampled"]):
                bits_at.append((k, n - 1))
    final, bits, lost = ref.run(caps, tracks, bits_at)
    carry = [final[v] for v in out["capture_of"]] \
        if out["kind"] == "fleet" else [final[-1]]
    return {"carry": carry, "bits": {k: b for (k, _), b in bits.items()},
            "lost": lost, "null0": null0, "align": align}


def _frame_gap(start: int, ref_align: tuple, fs: int):
    """Samples between a read grid that starts at sample `start` and the
    nearest frame start that the reference found; None where the
    reference's frame did not sync."""
    at, synced = ref_align
    d = (start - at) % fs
    return min(d, fs - d) if synced else None


def carry_gaps(traffic, prog: dict, ref_carry: list) -> dict:
    """(freq_gap_bins, l1_gap) of the program's carry (one row a stream)
    against the reference's carry of each stream."""
    nfft = S.OFDM_MODES[traffic.ensemble.mode].nb_fft
    freq, l1 = 0.0, 0.0
    for b, r in enumerate(ref_carry):
        for f in ("freq_coarse", "freq_fine"):
            freq = max(freq, abs(float(prog[f][b]) - r[f]) * nfft)
        l1 = max(l1, abs(float(prog["signal_l1_avg"][b]) - r["signal_l1_avg"])
                 / abs(r["signal_l1_avg"]))
    return {"freq_gap_bins": freq, "l1_gap": l1}


def compare(traffic, out: dict, window: tuple, cell_check: dict,
            device) -> dict:
    """-> {"numbers": {name: value}, "attempted", "failed", "align_gaps":
    the fleet's read grids' distance in samples from the reference's
    frames, a capture each (None for a tuner)}."""
    ref = reference_numbers(traffic, out, cell_check, device)
    nb_cifs = S.dab_params(traffic.ensemble.mode).nb_cifs
    fs = traffic.frame_samples
    gaps = None                 # the fleet's read grids against the frames
    if out["kind"] == "fleet":
        K = out["frames_per_round"]
        fr0 = [int(round(s / 2 / fs)) for s in out["start_bytes"]]

        def unit_cifs(b, r):
            f = fr0[out["capture_of"][b]] + r * K
            return nb_cifs * f, nb_cifs * (f + K)
        lost = len(out["fib_short"]) + int(out["carry"]["total_desync"].sum())
        gaps = [_frame_gap(s // 2, a, fs)
                for s, a in zip(out["start_bytes"], ref["align"])]
        lost += sum(gaps[v] is None or gaps[v] > 0 for v in out["capture_of"])
    else:
        ja = int(round(ref["null0"] / fs))

        def unit_cifs(b, j):
            return nb_cifs * (ja + j), nb_cifs * (ja + j + 1)
        # frames whose whole window was handed in after the first NULL
        # (acquisition starts a frame up to 2 blocks of 100 samples early)
        window_len = Reference.window_len_of(traffic.ensemble.mode)
        lead = ref["null0"] - out["start_bytes"][0] // 2
        expected = (out["bytes_in"] // 2 - lead + 200 - window_len) // fs + 1
        lost = int(out["carry"]["total_desync"].sum()) + max(
            0, expected - out["frames"] - 1)
    aus = access_units(traffic, out, unit_cifs, window)
    numbers = {"au_errors": aus["wrong"] + aus["missing"],
               "db_errors": database(traffic, out["dbs"]),
               "lost_sync": lost}
    numbers.update(carry_gaps(traffic, out["carry"], ref["carry"]))
    if out["kind"] == "tuner":
        gap = 0
        for k, (_, bits) in enumerate(out["sampled"]):
            d = np.abs(bits.astype(np.int32) - ref["bits"][k].astype(np.int32))
            gap = max(gap, int(d.max()))
        numbers["softbit_gap"] = gap
    return {"numbers": numbers, "attempted": aus["attempted"],
            "failed": aus["missing"] + aus["wrong"],
            "align_gaps": gaps}
