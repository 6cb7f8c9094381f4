"""The soft bits' fetch of the streaming demodulator: host ms a second of
air inside the program's span demod/fetch (models/demodulator.py:
StreamingDemodulator.process, once a frame step or scan), from the step's
return to its bits in host memory: the wait for the step on the card and
the copy of its sync flag, bits and offset to the host."""

from harness.probes import Span


def probe(run):
    return Span("demod/fetch")
