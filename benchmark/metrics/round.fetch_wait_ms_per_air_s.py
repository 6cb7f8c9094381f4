"""The wait for the round's bytes: host ms a second of air inside the
program's span fleet/fetch_wait (models/fused_fleet.py:_Fetch.arrays), the
host waiting on the event behind the round's copies to pinned memory, then
taking them as numpy arrays. Near zero while the host byte layer is slower
than the card; it grows once the card sets the pace."""

from harness.probes import Span


def probe(run):
    return Span("fleet/fetch_wait")
