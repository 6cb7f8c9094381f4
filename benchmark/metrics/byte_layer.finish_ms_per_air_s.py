"""The fleet byte layer's superframe finish: host ms a second of air inside
the program's span fleet/finish (models/fused_fleet.py:
FusedFleet._consume_batched, once a CIF that completes superframes): the
RS-corrected codewords of the CIF's superframes to their headers and
access units, and the events made of them."""

from harness.probes import Span


def probe(run):
    return Span("fleet/finish")
