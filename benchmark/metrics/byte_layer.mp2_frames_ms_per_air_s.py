"""The MP2 byte layer: host ms a second of air inside the program's span
fleet/mp2_frames (models/fused_fleet.py: FusedFleet._mp2_events, once a
round with an "mp2" subchannel; with consume workers once a stream and
round): the round's logical frames sliced from its bytes, the MPEG header
check counted in MP2_STATS, and the events built. None where the program
has no such span (it names none there) or the window served no MP2
subchannel."""

from harness.probes import Span


def probe(run):
    return Span("fleet/mp2_frames")
