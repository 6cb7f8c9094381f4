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
"""

import dataclasses

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


def msc_state_from_jax(state: dict, device="cpu") -> dict:
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
