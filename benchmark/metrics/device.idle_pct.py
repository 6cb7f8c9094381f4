"""The card's idle share of the traced window: 100 minus the union of
device activity (kernels, copies, sets) over the window's length, from
torch.profiler."""

from harness.probes import Probe


class _Idle(Probe):
    def value(self, run):
        s = run.trace.summary if run.trace is not None else None
        if not s or s["window_s"] <= 0 or s["busy_s"] <= 0:
            return None
        return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def probe(run):
    return _Idle()
