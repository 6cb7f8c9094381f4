"""Device selection for the CLI apps.

Every app takes ``--backend {cuda,cpu}`` (default ``cuda``) and turns it into
the one ``torch.device`` that is passed down to every model it builds. Asking
for ``cuda`` on a machine without a usable GPU raises: the port never falls
back to the CPU behind the user's back.
"""

import argparse

import numpy as np
import torch


def add_backend_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--backend", default="cuda", choices=["cuda", "cpu"],
        help="device the signal chain runs on (default: cuda; raises if "
             "no GPU is present)")


def apply_backend(args: argparse.Namespace) -> torch.device:
    """The device the --backend flag names; raises for cuda without a GPU."""
    backend = getattr(args, "backend", "cuda")
    if backend == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--backend cuda was asked for, but "
                           "torch.cuda.is_available() is False")
    return torch.device("cuda", torch.cuda.current_device())


def to_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    """numpy array (or tensor) -> tensor on `device`. A read-only numpy
    array (np.frombuffer, a broadcast view) is copied first, since torch
    cannot share it."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.require(x, dtype=dtype, requirements="W"))
    return x.to(device)
