"""The RS(120,110) decode: host ms a second of air inside
ReedSolomonDecoder.decode, self time (a call made inside another
self-timed call is not counted)."""

from harness.probes import MethodTime


def probe(run):
    return MethodTime("dab_radio_tpu_torch.ops.rs:ReedSolomonDecoder.decode",
                      self_time=True)
