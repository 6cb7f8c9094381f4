"""The fleet byte layer's frame intake: host ms a second of air inside the
program's span fleet/push_frames (models/fused_fleet.py:
FusedFleet._consume_batched, once a CIF): each audio subchannel's bytes
sliced from the round, tobytes, SuperframeProcessor.push_frame, and the
codewords of the superframes it completes reshaped for the batched RS."""

from harness.probes import Span


def probe(run):
    return Span("fleet/push_frames")
