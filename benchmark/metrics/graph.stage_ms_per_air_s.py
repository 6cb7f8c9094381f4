"""The captured programs' staging: host ms a second of air inside the
program's span graph/stage (utils/graphs.py:CapturedProgram._load), a call
whose arguments pass through pinned host memory on their way to the
graph's inputs: the copy into the pinned buffer, and its wait for the
previous copy out of it. In the fleet the round's 50 MB of u8 IQ; in the
tuner each frame's window and the FIC and MSC programs' soft bits."""

from harness.probes import Span


def probe(run):
    return Span("graph/stage")
