"""The one-stream MSC path: host ms a second of air inside the receiver's
own span radio/msc_channels (utils/profiler.py; DabReceiver.process_frame's
decode group dispatch, its fetch, descrambling, superframes, RS, AUs)."""

from harness.probes import Span


def probe(run):
    return Span("radio/msc_channels")
