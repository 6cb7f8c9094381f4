"""The one-stream byte layer: host ms a second of air inside the program's
span radio/superframes (models/receiver.py:DabReceiver._msc_channels, once
a frame): every channel's payloads of the frame through _handle_payload,
superframe assembly, RS, finish and the access-unit observers."""

from harness.probes import Span


def probe(run):
    return Span("radio/superframes")
