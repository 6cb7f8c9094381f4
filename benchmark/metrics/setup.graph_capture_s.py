"""Set-up's graph captures: host seconds of the captured programs' first
calls (the eager warm-up run and the capture) before the window, from
utils/graphs.py:GRAPH_STATS["capture_s"] as it stands when the window
opens. None where the program keeps no such count or captured nothing
(an eager run)."""

import importlib

from harness.probes import Probe


class _CaptureSeconds(Probe):
    def __init__(self):
        self.seconds = None

    def start(self, run):
        graphs = importlib.import_module("dab_radio_tpu_torch.utils.graphs")
        stats = getattr(graphs, "GRAPH_STATS", None)
        if stats is not None and stats["captures"]:
            self.seconds = float(stats["capture_s"])

    def value(self, run):
        return self.seconds


def probe(run):
    return _CaptureSeconds()
