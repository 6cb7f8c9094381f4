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


# ------------------------------------------------- the decoder's device stage

BATCHES = [0, 1, 8, 2304]           # 2,304: a CIF of the 16-stream fleet
CORRUPTIONS = ["clean", "correctable", "uncorrectable", "parity"]


def _corrupt(enc, nroots, how, rng):
    """(a corrupted copy of enc, the rows corrupted). Every third row: 1
    to t/2 symbol errors, t/2 + 2 (more than the code corrects, no more
    than it detects), or one error in a parity byte."""
    bad = enc.copy()
    rows = np.arange(0, enc.shape[0], 3) if how != "clean" else \
        np.arange(0)
    n = enc.shape[1]
    for r in rows:
        if how == "parity":
            pos = rng.integers(n - nroots, n, 1)
        else:
            k = rng.integers(1, nroots // 2 + 1) if how == "correctable" \
                else nroots // 2 + 2
            pos = rng.choice(n, k, replace=False)
        bad[r, pos] ^= rng.integers(1, 256, pos.size).astype(np.uint8)
    return bad, rows


@pytest.mark.parametrize("how", CORRUPTIONS)
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("nroots,pad", SHAPES)
def test_decode_on_a_device_equals_the_host_decode(nroots, pad, batch, how):
    """decode(cw, device=cpu) computes the syndromes with
    rs_syndromes_device and must give the host decode's corrected bytes and
    error counts exactly; RS_STATS counts each call's codewords, those
    computed on the device, the rows gated to Berlekamp-Massey and those
    that failed."""
    rng = np.random.default_rng([nroots, batch, CORRUPTIONS.index(how)])
    n = 255 - pad
    msg = rng.integers(0, 256, (batch, n - nroots)).astype(np.uint8)
    enc = rs.rs_encode(msg, nroots, pad)
    bad, rows = _corrupt(enc, nroots, how, rng)
    dec = rs.ReedSolomonDecoder(nroots, pad)

    def counted(**kw):
        before = dict(rs.RS_STATS)
        out = dec.decode(bad, **kw)
        return out, {k: rs.RS_STATS[k] - before[k] for k in before}
    (fixed, nerr), host = counted()
    (dfixed, dnerr), dev = counted(device=torch.device("cpu"))
    assert fixed.dtype == dfixed.dtype == np.uint8
    assert nerr.dtype == dnerr.dtype == np.int32
    np.testing.assert_array_equal(dfixed, fixed)
    np.testing.assert_array_equal(dnerr, nerr)
    failed = int((nerr < 0).sum())
    assert host == dict(calls=1, codewords=batch, device_codewords=0,
                        gated_rows=rows.size, failed_rows=failed)
    assert dev == dict(host, device_codewords=batch)
    clean = np.setdiff1d(np.arange(batch), rows)
    np.testing.assert_array_equal(fixed[clean], enc[clean])
    assert not nerr[clean].any()
    if how in ("correctable", "parity"):
        np.testing.assert_array_equal(fixed, enc)
        assert (nerr[rows] > 0).all()
    if how == "uncorrectable" and batch:
        assert failed > 0


def test_device_constants_are_built_once(monkeypatch):
    """The device stage's constants are made once per (code, device) and
    stay there: the bit matrix is built and copied once for two decodes,
    and a FusedFleet makes them in its construction, so its first decode
    builds nothing."""
    from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
    from dab_radio_tpu_torch.params import SubchannelConfig
    built = []
    matrix = rs.syndrome_bit_matrix

    def counting(nroots, pad):
        built.append((nroots, pad))
        return matrix(nroots, pad)
    monkeypatch.setattr(rs, "syndrome_bit_matrix", counting)
    monkeypatch.setattr(rs, "_SYNDROME_CONSTANTS", {})
    cw = rs.rs_encode(np.zeros((4, 188), np.uint8), 16, 51)
    cw[1, 5] ^= 3
    dec = rs.packet_rs()
    for _ in range(2):
        fixed, nerr = dec.decode(cw, device="cpu")
        assert nerr.tolist() == [0, 1, 0, 0] and not fixed.any()
    assert built == [(16, 51)]
    consts = rs.syndrome_constants(16, 51, torch.device("cpu"))
    assert consts is rs.syndrome_constants(16, 51, "cpu")
    assert consts[0].dtype == torch.float32 and consts[3] is None

    FusedFleet(1, [SubchannelConfig(0, 12, False, 0, "A", 2)], 2, 2,
               device="cpu")
    assert built == [(16, 51), (10, 135)]
    made = dict(rs._SYNDROME_CONSTANTS)
    rs.dab_plus_rs().decode(np.zeros((8, 120), np.uint8), device="cpu")
    assert built == [(16, 51), (10, 135)]
    assert rs._SYNDROME_CONSTANTS == made
