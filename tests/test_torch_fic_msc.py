"""FIC and MSC decode and encode of the PyTorch port against the JAX
package: identical FIBs and CRC counts, identical MSC payloads (also while
the 16-CIF deinterleaver fills), identical encoder output, and the MSC
state carried across with ``convert.py``.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

from dab_radio_tpu.params import SubchannelConfig as JConfig
from dab_radio_tpu.dab import fic as jfic, msc as jmsc
from dab_radio_tpu_torch.dab import fic as tfic, msc as tmsc
from dab_radio_tpu_torch.convert import (msc_state_from_jax,
                                         subchannel_config_from_jax)
from dab_radio_tpu_torch.params import SubchannelConfig as TConfig

torch.set_num_threads(1)

# the JAX package's configs; the port gets its own through convert.py
EEP = JConfig(0, 12, False, eep_type="A", eep_prot_level=2)
UEP = JConfig(12, 21, True, uep_table_index=1)
EEP_B = JConfig(33, 12, False, eep_type="A", eep_prot_level=2)


def _t(cfg) -> TConfig:
    return subchannel_config_from_jax(cfg)


def _noisy(soft, rng, std=55.0):
    x = soft.astype(np.float64) + rng.normal(0, std, soft.shape)
    return np.clip(np.round(x), -127, 127).astype(np.int8)


def test_fic_encoder_and_decoder_match_jax():
    rng = np.random.default_rng(0)
    payloads = [bytes(rng.integers(0, 256, rng.integers(5, 29)).astype(np.uint8))
                for _ in range(12)]
    soft_j = jfic.FICEncoder(1).encode_fic(payloads)
    soft_t = tfic.FICEncoder(1).encode_fic(payloads)
    np.testing.assert_array_equal(soft_t, soft_j)
    noisy = _noisy(soft_j, rng)
    noisy[rng.choice(noisy.shape[0], 40, replace=False)] = 0
    garbled = noisy.copy()
    garbled[:2304] = rng.integers(-127, 128, 2304)       # one CIF's FIBs fail
    for soft in (noisy, garbled):
        fj, ej = jfic.FICDecoder(1).decode_fic(soft)
        ft, et = tfic.FICDecoder(1, device="cpu").decode_fic(soft)
        assert ft == fj
        assert et["crc_errors"] == ej["crc_errors"]
        np.testing.assert_array_equal(et["viterbi_error"],
                                      np.asarray(ej["viterbi_error"]))
    assert len(ft) == 9 and et["crc_errors"] == 3
    assert fj[0] == payloads[3] + b"\xff" + bytes(30 - len(payloads[3]) - 1)


def _msc_stream(cfgs, nb_frames, seed):
    """Encoded MSC CIFs of random payloads for the given subchannels:
    (nb_frames, 4, 864*64) int8 soft bits with noise."""
    rng = np.random.default_rng(seed)
    encs_j = [jmsc.MSCEncoder(c) for c in cfgs]
    encs_t = [tmsc.MSCEncoder(_t(c)) for c in cfgs]
    frames = np.zeros((nb_frames, 4, 864 * 64), np.int8)
    for f in range(nb_frames):
        for k in range(4):
            for c, ej, et in zip(cfgs, encs_j, encs_t):
                pay = rng.integers(0, 256, ej.nb_data_bytes).astype(np.uint8)
                a = ej.encode_cif(pay.tobytes())
                np.testing.assert_array_equal(et.encode_cif(pay.tobytes()), a)
                frames[f, k, c.start_address * 64:
                       c.start_address * 64 + a.shape[0]] = a
    return _noisy(frames, rng, std=40.0)


def test_msc_decode_frame_matches_jax_through_fill():
    frames = _msc_stream([EEP, UEP], 6, seed=1)
    for cfg in (EEP, UEP):
        dj, dt = jmsc.MSCDecoder(cfg), tmsc.MSCDecoder(_t(cfg), device="cpu")
        outs = []
        for f in frames:
            pj, pt = dj.decode_frame(f), dt.decode_frame(f)
            assert pt == pj
            outs += pt
        assert outs[:15] == [None] * 15 and all(outs[15:])
        np.testing.assert_array_equal(dt.history.numpy(),
                                      np.asarray(dj.history))


def test_msc_decode_cif_matches_jax():
    frames = _msc_stream([UEP], 5, seed=2)
    dj, dt = jmsc.MSCDecoder(UEP), tmsc.MSCDecoder(_t(UEP), device="cpu")
    for f in frames:
        for cif in f:
            assert dt.decode_cif(cif) == dj.decode_cif(cif)
    assert dt.nb_pushed == dj.nb_pushed == 20


def test_msc_decode_frame_group_matches_jax():
    frames = _msc_stream([EEP, EEP_B], 6, seed=3)
    dj = [jmsc.MSCDecoder(EEP), jmsc.MSCDecoder(EEP_B)]
    dt = [tmsc.MSCDecoder(_t(EEP), device="cpu"),
          tmsc.MSCDecoder(_t(EEP_B), device="cpu")]
    assert tmsc.group_key(_t(EEP)) == tmsc.group_key(_t(EEP_B))
    for f in frames:
        rj = jmsc.decode_frame_group(dj, f)
        rt = tmsc.decode_frame_group(dt, f)
        assert rt == rj
    assert all(p is not None for p in rt[0]) and rt[0] != rt[1]
    # handles: dispatch then finalize equals the one-shot call
    h = tmsc.dispatch_frame_group(dt, [frames[0], frames[1]])
    assert len(tmsc.finalize_frame_group(h)) == 2


def test_msc_state_from_jax_resumes_mid_fill():
    frames = _msc_stream([EEP], 6, seed=4)
    dj = jmsc.MSCDecoder(EEP)
    for f in frames[:2]:
        dj.decode_frame(f)
    assert dj.nb_pushed == 8                     # deinterleaver still filling
    dt = tmsc.MSCDecoder.__new__(tmsc.MSCDecoder)
    dt.__setstate__(msc_state_from_jax(dj.__getstate__(), device="cpu"))
    assert type(dt.cfg) is TConfig and dt.cfg == _t(EEP)
    assert _t(dataclasses.asdict(EEP)) == _t(EEP)         # from a field dict
    for f in frames[2:]:
        assert dt.decode_frame(f) == dj.decode_frame(f)
    state = pickle.loads(pickle.dumps(dt)).__getstate__()
    assert isinstance(state["history"], np.ndarray)
    np.testing.assert_array_equal(state["history"], np.asarray(dj.history))


@pytest.mark.parametrize("std", [40.0, 75.0], ids=["operating", "heavy"])
def test_tiled_decode_mode_matches_jax(std):
    """set_decode_mode("tiled") through MSCDecoder (per CIF and per frame)
    and the group decode: the JAX package's payloads in its tiled mode, at
    an operating noise level, where they are also the exact mode's, and at a
    heavy one, where they need not be."""
    rng = np.random.default_rng(7)
    frames = _noisy(_msc_stream([EEP, EEP_B, UEP], 6, seed=5), rng,
                    std=np.sqrt(max(std ** 2 - 40.0 ** 2, 0.0)))
    exact = tmsc.MSCDecoder(_t(UEP), device="cpu")
    want_exact = [p for f in frames for p in exact.decode_frame(f)]
    try:
        jmsc.set_decode_mode("tiled")
        tmsc.set_decode_mode("tiled")
        dj, dt = jmsc.MSCDecoder(UEP), tmsc.MSCDecoder(_t(UEP), device="cpu")
        cj, ct = jmsc.MSCDecoder(UEP), tmsc.MSCDecoder(_t(UEP), device="cpu")
        gj = [jmsc.MSCDecoder(EEP), jmsc.MSCDecoder(EEP_B)]
        gt = [tmsc.MSCDecoder(_t(EEP), device="cpu"),
              tmsc.MSCDecoder(_t(EEP_B), device="cpu")]
        got = []
        for f in frames:
            pt = dt.decode_frame(f)
            assert pt == dj.decode_frame(f)
            got += pt
            assert [ct.decode_cif(c) for c in f] == \
                [cj.decode_cif(c) for c in f] == pt
            assert tmsc.decode_frame_group(gt, f) == \
                jmsc.decode_frame_group(gj, f)
    finally:
        jmsc.set_decode_mode("exact")
        tmsc.set_decode_mode("exact")
    assert got[:15] == [None] * 15 and all(got[15:])
    if std == 40.0:
        assert got == want_exact
    assert tmsc._DECODE_MODE == "exact"
    assert dt.decode_frame(frames[0]) is not None       # exact again
