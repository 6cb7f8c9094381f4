"""The batched superframe finish's batch: superframes handed to
dab/aac.py:SuperframeProcessor.finish_batch a call, from aac.py:SF_STATS
("superframes" over "calls") read when the window opens and when it
closes. 1 where each superframe is finished alone (the tuner, through
finish); None where the program keeps no such count or the window made no
call."""

import importlib

from harness.probes import Probe

KEYS = ("calls", "superframes")


def _stats():
    aac = importlib.import_module("dab_radio_tpu_torch.dab.aac")
    stats = getattr(aac, "SF_STATS", None)
    return None if stats is None else [stats[k] for k in KEYS]


class _BatchSize(Probe):
    def __init__(self):
        self.opened = self.closed = None

    def start(self, run):
        self.opened = _stats()

    def stop(self, run):
        self.closed = _stats()

    def value(self, run):
        if self.opened is None or self.closed is None:
            return None
        calls, superframes = (b - a for a, b in zip(self.opened, self.closed))
        return superframes / calls if calls else None


def probe(run):
    return _BatchSize()
