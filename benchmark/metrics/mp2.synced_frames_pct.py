"""The MP2 byte layer's synced share: of the MP2 frames that the window's
rounds produced, the percentage whose first two bytes carry the MPEG audio
sync and MPEG-1 Layer II, from models/fused_fleet.py:MP2_STATS ("synced"
over "frames") read when the window opens and when it closes. None where
the program keeps no such count or the window produced no MP2 frame."""

import importlib

from harness.probes import Probe

KEYS = ("frames", "synced")


def _stats():
    fleet = importlib.import_module("dab_radio_tpu_torch.models.fused_fleet")
    stats = getattr(fleet, "MP2_STATS", None)
    return None if stats is None else [stats[k] for k in KEYS]


class _SyncedShare(Probe):
    def __init__(self):
        self.opened = self.closed = None

    def start(self, run):
        self.opened = _stats()

    def stop(self, run):
        self.closed = _stats()

    def value(self, run):
        if self.opened is None or self.closed is None:
            return None
        frames, synced = (b - a for a, b in zip(self.opened, self.closed))
        return 100.0 * synced / frames if frames else None


def probe(run):
    return _SyncedShare()
