"""The captured round: device ms a second of air between CUDA events
around each call of FusedFleet.program (the round's CUDA graph and the bit
packing). The host's staging of the round's u8 input into the graph's
buffers happens inside the call, so it lies between the events too."""

from harness.probes import CudaEvents


def probe(run):
    return CudaEvents("fleet", "program")
