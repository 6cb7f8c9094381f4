"""The one traffic generator: a cell's traffic parameters and its
configuration's multiplex in, periodic u8 captures and the units they
carry out: a DAB+ service's access units, a classic DAB service's MP2
frames.

Every distinct capture is one period of ``period_frames`` frames of the
ensemble, coded as if the period had been sent before (``periodic``), so
that a stream that loops it is a seamless broadcast: superframes and the
time interleaver run on across the seam. The period starts at a frame's
NULL symbol, where the signal is zero, so the carrier offset's phase may
jump there. Capture v has its own units, carrier offset and noise, all
drawn from (seed, v), service k's units from (seed, v, k): the same seed
gives the same captures.
"""

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from . import channel, standard as S, transmit as T


@dataclass
class Traffic:
    ensemble: T.Ensemble
    period_frames: int
    frame_samples: int
    captures: List[np.ndarray]          # (2 * period samples,) u8 each
    # [capture][service][group][unit]: a DAB+ superframe's AUs, or a
    # classic DAB logical frame's one MP2 frame
    sent: List[List[List[List[bytes]]]]

    def groups(self, svc: T.Service) -> int:
        """Groups of units (superframes, MP2 frames) a service carries in
        one period."""
        return self.period_frames * S.dab_params(
            self.ensemble.mode).nb_cifs // svc.group_frames

    @property
    def superframes(self) -> int:
        """Superframes a DAB+ subchannel carries in one period."""
        return self.period_frames * S.dab_params(
            self.ensemble.mode).nb_cifs // T.SUPERFRAME_FRAMES


# the traffic parameters the generator reads; a driver may read more of a
# cell's "traffic" and names them in its module's TRAFFIC_KEYS
KEYS = {"period_frames", "snr_db", "captures"}


def _torch_seed(*key) -> int:
    return int(np.random.SeedSequence([*key]).generate_state(1, np.uint64)[0])


def capture_iq(ens: T.Ensemble, aus: List[List[List[bytes]]], frames: int,
               device, periodic: bool = True) -> torch.Tensor:
    """[service][group][unit] -> (frames * frame_samples,) complex64 IQ of
    the ensemble carrying them, on `device`."""
    logical = {k: T.logical_frames(svc, aus[k])
               for k, svc in enumerate(ens.services)}
    bits = T.frame_bits(ens, logical, frames, periodic)
    return T.modulate(ens.mode, bits, device).reshape(-1)


def make(multiplex: dict, traffic: dict, seed: int, device) -> Traffic:
    ens = T.ensemble_of(multiplex)
    dab = S.dab_params(ens.mode)
    p = S.OFDM_MODES[ens.mode]
    frames = traffic["period_frames"]
    if any(frames * dab.nb_cifs % s.group_frames for s in ens.services):
        raise ValueError("a period must hold whole superframes")
    t = Traffic(ens, frames, p.nb_frame_samples, [], [])
    for v, cap in enumerate(traffic["captures"]):
        aus = [T.random_units(svc, t.groups(svc),
                              np.random.default_rng([seed, v, k]))
               for k, svc in enumerate(ens.services)]
        iq = capture_iq(ens, aus, frames, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(_torch_seed(seed, v, 1 << 20))
        u8 = channel.apply(iq, cap["cfo_bins"], traffic["snr_db"], p.nb_fft,
                           gen)
        t.captures.append(u8.cpu().numpy())
        t.sent.append(aus)
    return t
