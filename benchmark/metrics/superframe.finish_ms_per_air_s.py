"""The DAB+ superframe's end: host ms a second of air inside
SuperframeProcessor.finish (AU split, AU CRC, byte copies), self time."""

from harness.probes import MethodTime


def probe(run):
    return MethodTime("dab_radio_tpu_torch.dab.aac:SuperframeProcessor.finish",
                      self_time=True)
