"""The fleet's host byte layer: host ms a second of air inside
FusedFleet._consume (FIB CRC, FIG ingest, superframes, RS, observers),
wall time of each call."""

from harness.probes import MethodTime


def probe(run):
    return MethodTime(
        "dab_radio_tpu_torch.models.fused_fleet:FusedFleet._consume")
