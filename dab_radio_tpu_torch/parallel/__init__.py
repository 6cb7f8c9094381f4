"""The fused serving round on one device and over a mesh of GPU ranks (port
of ``dab_radio_tpu/parallel``): streams are data parallel ('ens'), a
stream's frame blocks are sequence parallel with a halo from the right
neighbour ('time'), and the MSC subchannels are split over ranks ('sub').
"""

from .mesh import (
    make_receiver_mesh,
    shard_demod_batch,
    make_timesharded_demod,
    make_coldstart_timesharded_demod,
    multichip_receiver_step,
)
from .distributed import (
    initialize,
    global_receiver_mesh,
    host_local_iq_to_global,
)
