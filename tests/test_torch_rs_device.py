"""The port's ``ops/rs.py:rs_syndromes_device`` (the RS syndromes as one
float32 product with ``syndrome_bit_matrix`` and a parity, on the tensor's
device) against ``rs_syndromes_numpy`` and the JAX package's function, on
the CPU. Tolerance: exact. The gate contract: clean codewords give all-zero
syndromes, corrupted rows fire and match the host syndromes exactly."""

import jax
import numpy as np
import pytest
import torch

from dab_radio_tpu.ops import rs as jrs
from dab_radio_tpu_torch.ops import rs


# DAB+ RS(120,110) and packet-mode RS(204,188)
SHAPES = [(10, 135), (16, 51)]


@pytest.mark.parametrize("nroots,pad", SHAPES)
@pytest.mark.parametrize("batch", [(64,), (3, 5)])
def test_device_syndromes_match_host_and_jax(nroots, pad, batch):
    rng = np.random.default_rng(3 + nroots)
    n = 255 - pad
    cw = rng.integers(0, 256, (*batch, n)).astype(np.uint8)
    got = rs.rs_syndromes_device(torch.from_numpy(cw), nroots, pad)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert tuple(got.shape) == (*batch, nroots)
    host = rs.rs_syndromes_numpy(cw, nroots, pad).reshape(*batch, nroots)
    np.testing.assert_array_equal(got.numpy(), host)
    want = np.asarray(jax.jit(
        lambda x: jrs.rs_syndromes_device(x, nroots, pad))(cw))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nroots,pad", SHAPES)
def test_device_syndromes_gate(nroots, pad):
    rng = np.random.default_rng(4)
    n = 255 - pad
    msg = rng.integers(0, 256, (16, n - nroots)).astype(np.uint8)
    enc = np.stack([rs.rs_encode(m, nroots, pad) for m in msg])
    syn = rs.rs_syndromes_device(torch.from_numpy(enc), nroots, pad)
    assert not syn.any()                      # clean -> gate stays closed
    bad = enc.copy()
    bad[3, 7] ^= 0x55
    bad[9, n - 1] ^= 0x01
    syn = rs.rs_syndromes_device(torch.from_numpy(bad), nroots, pad).numpy()
    fired = syn.any(axis=-1)
    assert fired[3] and fired[9] and fired.sum() == 2
    np.testing.assert_array_equal(syn, rs.rs_syndromes_numpy(bad, nroots, pad))
    # and the host decoder corrects exactly those rows
    fixed, nerr = rs.ReedSolomonDecoder(nroots, pad).decode(bad)
    np.testing.assert_array_equal(fixed, enc)
    assert nerr[3] == 1 and nerr[9] == 1 and nerr.sum() == 2
