"""The RS decode's device share: of the codewords the window's
ReedSolomonDecoder.decode calls took, the percentage whose syndromes were
computed on the device, from ops/rs.py:RS_STATS ("device_codewords" over
"codewords") read when the window opens and when it closes. 0 where every
call took the host gather (the tuner, a superframe a call); None where the
program keeps no such count or the window decoded nothing."""

import importlib

from harness.probes import Probe

KEYS = ("codewords", "device_codewords")


def _stats():
    rs = importlib.import_module("dab_radio_tpu_torch.ops.rs")
    stats = getattr(rs, "RS_STATS", None)
    return None if stats is None else [stats[k] for k in KEYS]


class _DeviceShare(Probe):
    def __init__(self):
        self.opened = self.closed = None

    def start(self, run):
        self.opened = _stats()

    def stop(self, run):
        self.closed = _stats()

    def value(self, run):
        if self.opened is None or self.closed is None:
            return None
        codewords, device = (b - a for a, b in zip(self.opened, self.closed))
        return 100.0 * device / codewords if codewords else None


def probe(run):
    return _DeviceShare()
