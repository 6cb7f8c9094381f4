"""K1's share of its roofline: the least time of the exact decode that the
cell's layout needs (every subchannel's and the FIC's trellis at its own
length, harness/roofline.py) for the frames decoded in the window, over
the device time of the Viterbi kernels (names in viterbi_roofline.json)
in the traced window. Padding of a launch and the overlap of a tiled
decode are not counted as work."""

import json
import os

from harness.probes import Probe
from harness.roofline import viterbi_bound_s
from traffic import standard as S

AIR_S_PER_FRAME = 0.096


def frame_work(ensemble) -> list:
    """[(messages, steps)] of one frame of one stream."""
    dab = S.dab_params(ensemble.mode)
    fic_steps = int(S.puncture_mask(S.fic_schedule()).shape[0]) // 4
    work = [(dab.nb_cifs, fic_steps)]
    for svc in ensemble.services:
        steps = int(S.puncture_mask(S.msc_schedule(svc.sub)).shape[0]) // 4
        work.append((dab.nb_cifs, steps))
    return work


class _Roofline(Probe):
    def __init__(self, names):
        self.names = names

    def value(self, run):
        if run.trace is None or run.trace.summary is None:
            return None
        kernel_s = run.trace.kernel_s(self.names)
        frames = round(run.air_s / AIR_S_PER_FRAME)
        if kernel_s <= 0 or frames <= 0:
            return None
        work = [(b * frames, t) for b, t in frame_work(run.traffic.ensemble)]
        return 100.0 * viterbi_bound_s(work) / kernel_s


def probe(run):
    with open(os.path.splitext(__file__)[0] + ".json") as f:
        return _Roofline(json.load(f)["kernels"])
