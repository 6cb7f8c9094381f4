"""Carry decode state from the JAX package into this one.

The JAX package's checkpoints are plain dicts of numpy arrays; these
functions normalise them to the port's checkpoint form, which is also numpy,
so either package can resume where the other stopped:

  sd = StreamingDemodulator(OFDMDemodulator(1, device=dev))
  sd.restore(demod_state_from_jax(jax_sd.snapshot()))
  dec = MSCDecoder.__new__(MSCDecoder)
  dec.__setstate__(msc_state_from_jax(jax_dec.__getstate__(), dev))
"""

import numpy as np

_CARRY_NP = (np.float32, np.float32, np.bool_, np.float32, np.int32, np.int32)


def demod_state_from_jax(snap: dict) -> dict:
    """``dab_radio_tpu`` StreamingDemodulator.snapshot() -> the port's
    StreamingDemodulator.restore() input: carry fields, acquire/track
    state, unread samples and the acquisition L1 level."""
    carry = [np.asarray(x).astype(dt) for x, dt in zip(snap["carry"], _CARRY_NP)]
    return {"carry": carry, "state": int(snap["state"]),
            "buf": np.asarray(snap["buf"], np.complex64),
            "l1": float(snap["l1"])}


def msc_state_from_jax(state: dict, device="cpu") -> dict:
    """``dab_radio_tpu`` MSCDecoder.__getstate__() -> the port's
    MSCDecoder.__setstate__() input: subchannel config, fill count and the
    (16, nb_bits) int8 deinterleaver history."""
    return {"cfg": state["cfg"], "nb_pushed": int(state["nb_pushed"]),
            "history": np.asarray(state["history"], np.int8),
            "device": str(device)}
