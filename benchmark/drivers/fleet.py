"""The serving fleet's loop: N streams through one FusedFleet, a round of
frames_per_round frames a call, as apps/fleet_serve.py serves files (its
defaults: deferred fetch, the next round's head passed as the tail, the
round captured as a CUDA graph, no consume workers, no prefetch), closed
loop: the next round is handed in as soon as process_round returns.

Stream b plays capture b % captures, looped from the byte offset that
FusedFleet.find_alignment gives on the capture's head. The rounds of a
period are stacked once in set-up; a round is then handed in as it is.

A classic DAB service's subchannel is served as "mp2", as
FusedFleet.from_receivers derives it from FIG 0/2's ASCTy: its MP2 frames
fire on_mp2_frame, one a logical frame, and are kept as units at index 0
of their round, as an AU is kept.
"""

import time
from array import array

import numpy as np

from harness.records import Latency
from harness.trace import ranged
from traffic.standard import dab_params


class Driver:
    def __init__(self, config: dict, cell: dict, traffic, device, rng):
        from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
        from dab_radio_tpu_torch.params import SubchannelConfig
        serving = config["serving"]
        self.N = serving["streams"]
        self.K = serving["frames_per_round"]
        ens = traffic.ensemble
        cfgs = [SubchannelConfig(s.sub.start_address, s.sub.length,
                                 s.sub.is_uep, s.sub.uep_table_index,
                                 s.sub.eep_type, s.sub.eep_prot_level)
                for s in ens.services]
        kinds = ["mp2" if s.kind == "dab" else "audio" for s in ens.services]
        self.fleet = FusedFleet(
            self.N, cfgs, transmission_mode=ens.mode, frames_per_step=self.K,
            device=device, viterbi=serving["viterbi"],
            consume_workers=serving["consume_workers"],
            subchannel_kinds=kinds if "mp2" in kinds else None)
        self.fleet.on_access_unit.append(self._on_au)
        if "mp2" in kinds:
            self.fleet.on_mp2_frame.append(self._on_mp2)
        fs = traffic.frame_samples
        period = 2 * traffic.period_frames * fs          # bytes
        chunk, tb = 2 * self.K * fs, self.fleet.tail_bytes
        if period % chunk:
            raise ValueError("a period must hold whole rounds")
        # each distinct capture's stream starts where the fleet aligns
        self.start_bytes = []
        for cap in traffic.captures:
            off = self.fleet.find_alignment(cap[:2 * 4 * fs])
            if off is None:
                raise RuntimeError("no frame sync on a capture's head")
            self.start_bytes.append(off)
        rows = [k % len(traffic.captures) for k in range(self.N)]
        self.capture_of = rows
        self.rounds_per_period = period // chunk
        self.blocks, self.tails = [], []
        looped = [np.concatenate([c, c[:chunk + tb]])
                  for c in traffic.captures]
        for r in range(self.rounds_per_period):
            blk = np.empty((self.N, chunk), np.uint8)
            tail = np.empty((self.N, tb), np.uint8)
            for b, v in enumerate(rows):
                at = (self.start_bytes[v] + r * chunk) % period
                blk[b] = looped[v][at:at + chunk]
                tail[b] = looped[v][at + chunk:at + chunk + tb]
            self.blocks.append(blk)
            self.tails.append(tail)
        self.rounds_in = 0
        self.in_window = False
        self.handed_in = []            # host clock of each process_round
        self.consuming = -1            # the round whose outputs arrive now
        # the AUs and MP2 frames (bytes, which the collector does not
        # track) and, in arrays, their index and round, per (stream,
        # subchannel); the latency samples in arrays: the records add no
        # work to the garbage collector while the window runs
        S = len(ens.services)
        self._aus = [[[] for _ in range(S)] for _ in range(self.N)]
        self._meta = [[array("q") for _ in range(S)] for _ in range(self.N)]
        self.latency = Latency()
        self.fib_short = []            # (round, stream) with a FIB lost
        self.fibs_per_round = self.K * dab_params(ens.mode).nb_fibs

    # ---- the loop ----

    def _on_au(self, b, s, i, n, au, header):
        self._aus[b][s].append(au)
        meta = self._meta[b][s]
        meta.append(i)
        meta.append(self.consuming)
        if i == 0:
            self.latency.add(time.perf_counter(),
                             self.handed_in[self.consuming], n)

    def _on_mp2(self, b, s, frame):
        self._on_au(b, s, 0, 1, frame, None)

    def step(self):
        r = self.rounds_in
        k = r % self.rounds_per_period
        self.handed_in.append(time.perf_counter())
        self.consuming = r - 1
        self.fleet.process_round(self.blocks[k], defer_fetch=True,
                                 tail_u8=self.tails[k])
        self.rounds_in += 1
        if r >= 1:
            short = np.nonzero(self.fleet.last_fib_ok < self.fibs_per_round)[0]
            self.fib_short += [(r - 1, int(b)) for b in short]

    @property
    def air_frames(self) -> int:
        """Frames whose outputs have come back: materialized rounds."""
        return self.fleet.materialized_rounds * self.K * self.N

    @property
    def last_unit(self) -> int:
        """The last round whose outputs have come back."""
        return self.rounds_in - 2

    def warm_up(self, rounds: int):
        for _ in range(rounds):
            self.step()

    def finish(self):
        """After the window: the deferred round's outputs."""
        self.consuming = self.rounds_in - 1
        self.fleet.flush()
        short = np.nonzero(self.fleet.last_fib_ok < self.fibs_per_round)[0]
        self.fib_short += [(self.consuming, int(b)) for b in short]

    # ---- the traced run's host ranges ----

    def trace_on(self):
        from torch.profiler import record_function
        from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
        program = self.fleet.program

        class Ranged:
            def __getattr__(self, name):
                return getattr(program, name)

            def __call__(self, *args):
                with record_function("bench/program"):
                    return program(*args)
        self._restore = (ranged(FusedFleet, "_consume", "bench/consume"),
                         program)
        self.fleet.program = Ranged()

    def trace_off(self):
        restore, self.fleet.program = self._restore
        restore()

    # ---- what the check reads ----

    def outputs(self) -> dict:
        carry = self.fleet.carry
        fields = ("freq_coarse", "freq_fine", "signal_l1_avg", "total_desync")
        return {
            "kind": "fleet",
            "carry": {f: getattr(carry, f).cpu().numpy().reshape(-1)
                      for f in fields},
            "dbs": [rx.db for rx in self.fleet.receivers],
            "aus": [(b, s, meta[2 * j], au, meta[2 * j + 1])
                    for b, (row, mrow) in enumerate(zip(self._aus, self._meta))
                    for s, (aus, meta) in enumerate(zip(row, mrow))
                    for j, au in enumerate(aus)],
            "capture_of": self.capture_of,
            "start_bytes": self.start_bytes,
            "frames_in": self.rounds_in * self.K,
            "frames_per_round": self.K,
            "fib_short": self.fib_short,
        }

    def close(self):
        del self.fleet

