"""One tuner's loop, as apps/radio_cli.py runs it with --benchmark: u8 IQ
blocks of block_bytes converted on the host (host/io.py), through
StreamingDemodulator.process (frames_per_step 1, the frame step captured)
into DabReceiver.process_frame (benchmark_all, every service decoded, the
FIC and MSC decodes captured), closed loop: the next block is handed in as
soon as the last frame of this one is decoded.

The stream is capture 0 looped, starting half a frame into the period, so
that acquisition finds the next NULL as it would on a live tuner."""

import time
from array import array

import numpy as np

from harness.records import Latency
from harness.trace import ranged


class Driver:
    def __init__(self, config: dict, cell: dict, traffic, device,
                 rng: np.random.Generator):
        from dab_radio_tpu_torch.host.io import IQReader
        from dab_radio_tpu_torch.models.demodulator import (
            OFDMDemodulator, StreamingDemodulator)
        from dab_radio_tpu_torch.models.receiver import DabReceiver
        if any(s.kind != "dab+" for s in traffic.ensemble.services):
            raise ValueError("the tuner driver serves DAB+ services only: "
                             "a classic DAB (MP2) service has no cell here")
        serving = config["serving"]
        mode = traffic.ensemble.mode
        self.block = serving["block_bytes"]
        self.sd = StreamingDemodulator(
            OFDMDemodulator(mode, device=device),
            frames_per_step=serving["frames_per_step"])
        self.rx = DabReceiver(mode, benchmark_all=True, device=device)
        self.rx.on_audio_channel.append(self._on_channel)
        self.service_of = {svc.subchannel_id: k for k, svc
                           in enumerate(traffic.ensemble.services)}
        self.reader = IQReader(None, "u8")
        cap = traffic.captures[0]
        self.period = cap.shape[0]
        self.looped = np.concatenate([cap, cap[:self.block]])
        self.start_bytes = 2 * (traffic.frame_samples // 2)
        self.blocks_in = 0
        self.frames = 0                # frames decoded
        self.t_in = 0.0                # host clock of the current block
        S = len(traffic.ensemble.services)
        self._aus = [[] for _ in range(S)]          # as the fleet keeps them
        self._meta = [array("q") for _ in range(S)]
        self._stray = []
        self.latency = Latency()
        self.in_window = False
        self.sample_size = cell["check"]["sampled_frames"]
        self.sampled = []              # (frame, soft bits): a reservoir
        self._seen = 0
        self._rng = rng

    def _on_channel(self, sub_id, ch):
        s = self.service_of.get(sub_id)

        if s is None:                  # a subchannel that was not sent
            aus, meta = self._stray, array("q")
        else:
            aus, meta = self._aus[s], self._meta[s]

        def on_au(i, n, au, header):
            aus.append(au)
            meta.append(i)
            meta.append(self.frames)
            if i == 0:
                self.latency.add(time.perf_counter(), self.t_in, n)
        ch.events.on_access_unit.append(on_au)

    def _keep(self, bits):
        """Reservoir sampling of the window's frames, from the seed."""
        self._seen += 1
        if len(self.sampled) < self.sample_size:
            self.sampled.append((self.frames, bits))
        else:
            k = int(self._rng.integers(0, self._seen))
            if k < self.sample_size:
                self.sampled[k] = (self.frames, bits)

    def step(self):
        at = (self.start_bytes + self.blocks_in * self.block) % self.period
        self.t_in = time.perf_counter()
        iq = self.reader.convert(self.looped[at:at + self.block])
        for bits in self.sd.process(iq):
            if self.in_window:
                self._keep(bits)
            self.rx.process_frame(bits)
            self.frames += 1
        self.blocks_in += 1

    @property
    def air_frames(self) -> int:
        return self.frames

    @property
    def last_unit(self) -> int:
        """The last frame decoded."""
        return self.frames - 1

    def warm_up(self, frames: int):
        while self.frames < frames:
            self.step()

    def finish(self):
        pass

    def trace_on(self):
        """Host ranges for the traced run: the IQ conversion, the
        demodulator's call and the receiver's frame (the program's own
        spans inside them name the time they cover)."""
        from dab_radio_tpu_torch.host.io import IQReader
        from dab_radio_tpu_torch.models.demodulator import StreamingDemodulator
        from dab_radio_tpu_torch.models.receiver import DabReceiver
        self._restore = [
            ranged(IQReader, "convert", "bench/iq_convert"),
            ranged(StreamingDemodulator, "process", "bench/demod_process"),
            ranged(DabReceiver, "process_frame", "bench/process_frame")]

    def trace_off(self):
        for restore in reversed(self._restore):
            restore()

    def outputs(self) -> dict:
        carry = self.sd.carry
        fields = ("freq_coarse", "freq_fine", "signal_l1_avg", "total_desync")
        return {
            "kind": "tuner",
            "carry": {f: getattr(carry, f).cpu().numpy().reshape(-1)
                      for f in fields},
            "dbs": [self.rx.db],
            "aus": [(0, s, meta[2 * j], au, meta[2 * j + 1])
                    for s, (aus, meta) in enumerate(zip(self._aus, self._meta))
                    for j, au in enumerate(aus)]
            + [(0, None, 0, au, 0) for au in self._stray],
            "capture_of": [0],
            "start_bytes": [self.start_bytes],
            "frames": self.frames,
            "bytes_in": self.blocks_in * self.block,
            "sampled": sorted(self.sampled, key=lambda fb: fb[0]),
        }

    def close(self):
        del self.sd, self.rx
