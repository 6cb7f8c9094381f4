"""Carry decode state and configuration objects from the JAX package into
this one. Nothing of that package is imported here: its objects come in as
they are, or as their field dicts, and are read by attribute or key.

The JAX package's checkpoints are plain dicts of numpy arrays; these
functions normalise them to the port's checkpoint form, which is also numpy,
so either package can resume where the other stopped:

  sd = StreamingDemodulator(OFDMDemodulator(1, device=dev))
  sd.restore(demod_state_from_jax(jax_sd.snapshot()))
  dec = MSCDecoder.__new__(MSCDecoder)
  dec.__setstate__(msc_state_from_jax(jax_dec.__getstate__(), dev))
  fleet.load_state(*fused_state_from_jax(jax_fleet._carry, jax_fleet._hist))
  msd.load_state(multistream_state_from_jax(jax_msd))
  fleet = ReceiverFleet.from_snapshot(
      fleet_snapshot_from_jax(jax_fleet.snapshot(), dev), dev)
"""

import dataclasses
import io
import pickle

import numpy as np

from .params import SubchannelConfig

_CARRY_NP = (np.float32, np.float32, np.bool_, np.float32, np.int32, np.int32)


def demod_state_from_jax(snap: dict) -> dict:
    """``dab_radio_tpu`` StreamingDemodulator.snapshot() -> the port's
    StreamingDemodulator.restore() input: carry fields, acquire/track
    state, unread samples and the acquisition L1 level."""
    carry = [np.asarray(x).astype(dt) for x, dt in zip(snap["carry"], _CARRY_NP)]
    return {"carry": carry, "state": int(snap["state"]),
            "buf": np.asarray(snap["buf"], np.complex64),
            "l1": float(snap["l1"])}


def _own(cls, obj):
    """An instance of the port's dataclass ``cls`` with the fields of
    ``obj``: an object with those attributes, or a dict with those keys."""
    if isinstance(obj, cls):
        return obj
    get = obj.__getitem__ if isinstance(obj, dict) else \
        lambda name: getattr(obj, name)
    return cls(**{f.name: get(f.name) for f in dataclasses.fields(cls)})


def subchannel_config_from_jax(cfg) -> SubchannelConfig:
    """``dab_radio_tpu.params.SubchannelConfig`` (the object, or its field
    dict) -> the port's SubchannelConfig."""
    return _own(SubchannelConfig, cfg)


def msc_state_from_jax(state: dict, device) -> dict:
    """``dab_radio_tpu`` MSCDecoder.__getstate__() -> the port's
    MSCDecoder.__setstate__() input: the port's subchannel config, fill
    count and the (16, nb_bits) int8 deinterleaver history."""
    return {"cfg": subchannel_config_from_jax(state["cfg"]),
            "nb_pushed": int(state["nb_pushed"]),
            "history": np.asarray(state["history"], np.int8),
            "device": str(device)}


def fused_state_from_jax(carry, hist):
    """The state of the JAX fused round (``multichip_receiver_step`` on a
    mesh whose 'time' axis is 1) -> the port's, as numpy: the DemodCarry's
    six leaves of shape (B, 1) in the port's field types, and the
    deinterleaver history (B, S, 16, nb_sub_bits) int8. Feed the result to
    ``FusedFleet.load_state`` or ``DemodCarry.from_numpy``; both packages
    then run the next round from the same state."""
    leaves = [np.asarray(x).astype(dt) for x, dt in zip(carry, _CARRY_NP)]
    if any(x.ndim != 2 or x.shape[1] != 1 for x in leaves):
        raise ValueError("fused_state_from_jax: the carry must have leading "
                         f"dims (B, 1), got {[x.shape for x in leaves]}")
    return leaves, np.asarray(hist).astype(np.int8)


def multistream_state_from_jax(msd) -> dict:
    """The streaming state of a ``dab_radio_tpu`` MultiStreamDemodulator
    (the object itself, read by attribute) -> the input of the port's
    ``MultiStreamDemodulator.load_state``: the DemodCarry's leaves of shape
    (B,) in the port's field types, each stream's unread samples, the lock
    flags, the acquisition levels and the count of frames emitted. Both
    then demodulate the samples pushed next alike."""
    return {"carry": [np.asarray(x).astype(dt)
                      for x, dt in zip(msd.carry, _CARRY_NP)],
            "bufs": [np.array(b) for b in msd.bufs],
            "tracking": np.array(msd.tracking, dtype=bool),
            "l1": np.array(msd.l1, dtype=np.float32),
            "frames_emitted": int(msd.frames_emitted),
            "ingest": msd.ingest}


_JAX_PACKAGE = "dab_radio_tpu"
# the port's classes whose pickled state names the device they live on
_STATE_NAMES_DEVICE = {("dab.fic", "FICDecoder"), ("dab.msc", "MSCDecoder"),
                       ("models.receiver", "DabReceiver")}


def _with_device(cls, device: str):
    """A stand-in for `cls` while unpickling: its state gets
    "device": device added (the JAX package's states name none) and the
    object is of class `cls` from then on."""
    def __setstate__(self, state):
        self.__class__ = cls
        cls.__setstate__(self, dict(state, device=device))
    return type(cls.__name__, (cls,), {"__setstate__": __setstate__})


class _ToPort(pickle.Unpickler):
    """Loads a pickle written by the JAX package with every class of that
    package replaced by the port's class of the same module and name (the
    port keeps the JAX package's module layout), on `device`. The JAX
    package is not imported."""

    def __init__(self, file, device):
        super().__init__(file)
        self.device = str(device)

    def find_class(self, module, name):
        if module != _JAX_PACKAGE and not module.startswith(_JAX_PACKAGE + "."):
            return super().find_class(module, name)
        sub = module[len(_JAX_PACKAGE):]
        cls = super().find_class(__package__ + sub, name)
        if (sub[1:], name) in _STATE_NAMES_DEVICE:
            cls = _with_device(cls, self.device)
        return cls


def fleet_snapshot_from_jax(blob: bytes, device) -> bytes:
    """``dab_radio_tpu`` ReceiverFleet.snapshot() -> the blob that the
    port's ``ReceiverFleet.from_snapshot(blob, device)`` takes: the same
    receivers (database, channels, deinterleaver histories as numpy,
    superframe and PAD/MOT state) as objects of the port's classes, each
    state naming `device` as the port's own snapshots do. What does not
    carry over is each receiver's memo of FIBs proven to change nothing: it
    is keyed by a mutation clock that is each package's own, so the port
    applies the FIC carousel's repeats once more (same database, a higher
    update count). Only a snapshot that this program's own JAX fleet wrote
    should be given: unpickling runs code."""
    return pickle.dumps(_ToPort(io.BytesIO(blob), device).load())
