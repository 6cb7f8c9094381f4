"""Multi-process runtime: process-group bring-up and each rank's own IQ
(port of ``dab_radio_tpu/parallel/distributed.py``).

The port runs one process a GPU rank. ``initialize`` brings up the
``torch.distributed`` process group of those processes, the ('ens', 'time',
'sub') mesh is built over all of its ranks (``global_receiver_mesh``), and
each rank keeps the IQ of its own shard on its own device: no global array
exists across processes (``host_local_iq_to_global`` returns the rank's
tensor and its global row offset).

A single process needs none of this: without a process group the mesh is
the one-rank mesh, on which every collective is the identity.

    torchrun --nproc-per-node 4 serve.py     # or, by hand, on every rank:
    initialize("file:///shared/rdzv", world_size=4, rank=r)
    mesh = global_receiver_mesh()
"""

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from .mesh import ReceiverMesh, make_receiver_mesh
from ..utils.backend import to_device

_initialized = False


def local_rank() -> int:
    """This process's rank on its machine: LOCAL_RANK as torchrun sets it,
    else its global rank, else 0."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def local_device() -> torch.device:
    """The card of this rank: cuda:(local rank modulo the cards). Raises
    without a GPU: the port never falls back to the CPU unasked."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "False): pass the CPU device explicitly")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def default_backend(world_size: int) -> str:
    """NCCL when every rank of this machine has a card of its own, else gloo
    (NCCL refuses two ranks on one card, and needs CUDA)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if torch.cuda.is_available() and local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(init_method: str = None, world_size: int = None,
               rank: int = None, backend: str = None,
               timeout: timedelta = timedelta(seconds=60)) -> bool:
    """Bring up the process group; True if this call did.

    Idempotent: a second call, or one in a process whose group is already
    up, returns False. So does a plain single process: no argument and no
    WORLD_SIZE in the environment, or world_size 1 with no init_method.
    The arguments follow torchrun's rules: world_size and rank default to
    WORLD_SIZE and RANK, init_method to "env://" (MASTER_ADDR and
    MASTER_PORT). backend defaults to ``default_backend``; with NCCL the
    card cuda:(LOCAL_RANK, else rank, modulo the cards) becomes the
    process's current card and the group's device, the one that
    ``local_device()`` names after this call."""
    global _initialized
    if _initialized or (dist.is_available() and dist.is_initialized()):
        return False
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
        if "WORLD_SIZE" not in os.environ and init_method is None:
            return False                     # a plain single process
    if world_size == 1 and init_method is None:
        return False                         # explicitly one process
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    backend = backend or default_backend(world_size)
    kw = {}
    if backend == "nccl":
        # the group is not up yet, so the card comes from this call's rank
        # (LOCAL_RANK first, as torchrun sets it)
        card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))
                            % torch.cuda.device_count())
        torch.cuda.set_device(card)
        kw["device_id"] = card
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, timeout=timeout,
                            **kw)
    _initialized = True
    return True


def shutdown():
    """Take the process group down, if this module brought it up."""
    global _initialized
    if _initialized and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def global_receiver_mesh(axis_sizes=None) -> ReceiverMesh:
    """The ('ens', 'time', 'sub') mesh over every rank of the process group
    (the one-rank mesh without one), with make_receiver_mesh's factoring.
    Every rank calls it."""
    return make_receiver_mesh(axis_sizes=axis_sizes)


def host_local_iq_to_global(mesh: ReceiverMesh, iq_local, device=None):
    """This rank's IQ block (B_loc, ...) on its device, and the global row
    of its first stream. The rank holds the streams of its ens coordinate,
    so the global batch is B_loc * n_ens, and the rank's streams are the
    rows [offset, offset + B_loc). device defaults to local_device()."""
    x = to_device(iq_local, torch.device(device) if device is not None
                  else local_device())
    return x, mesh.coords["ens"] * x.shape[0]
