"""The one-stream MSC decode's fetch: host ms a second of air inside the
program's span msc/fetch (dab/msc.py:finalize_frame_group, once a decode
group a frame), the wait for the group's decoded bits and their copy to
the host."""

from harness.probes import Span


def probe(run):
    return Span("msc/fetch")
