"""Tests of the PyTorch port that need an NVIDIA GPU: the CUDA kernels
against their plain versions, and the receive chain on the card against the
same chain on the CPU. They skip without a card.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dab_radio_tpu.params import SubchannelConfig
from dab_radio_tpu_torch.dab import fic, msc
from dab_radio_tpu_torch.kernels import viterbi_acs as K
from dab_radio_tpu_torch.models.demodulator import (OFDMDemodulator,
                                                    StreamingDemodulator)
from dab_radio_tpu_torch.models.transmitter import (EnsembleTransmitter,
                                                    ServiceSpec)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _noisy(x, rng, std):
    y = x.astype(np.float64) + rng.normal(0.0, std, x.shape)
    return np.clip(np.round(y), -127, 127).astype(np.int8)


@pytest.mark.parametrize("B,T", [(4, 774), (72, 1542), (130, 200), (3, 9222)])
def test_viterbi_kernels_match_plain(cuda, B, T):
    rng = np.random.default_rng(B)
    d = rng.integers(-127, 128, (B, T, 4)).astype(np.int8)
    d[:, ::4, 3] = 0
    d[0] = 0                                   # every candidate ties
    dc = torch.as_tensor(d, device=cuda)
    K.reset_launches()
    dec, err = K.viterbi_acs(dc)
    bits = K.chainback(dec)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"viterbi_acs": 1, "viterbi_chainback": 1}
    assert K.ACS_LAUNCHES_BY_T == {T: 1}
    pdec, perr = K.viterbi_acs_plain(dc)
    assert torch.equal(dec, pdec) and torch.equal(err, perr)
    assert torch.equal(bits, K.chainback_plain(pdec))
    cbits, cerr = K.decode(torch.as_tensor(d))          # CPU: plain version
    assert torch.equal(bits.cpu(), cbits) and torch.equal(err.cpu(), cerr)


def test_viterbi_wrappers_check_cuda_inputs(cuda):
    with pytest.raises(ValueError):
        K.viterbi_acs(torch.zeros((2, 10, 4), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        K.viterbi_acs(torch.zeros((2, 10, 3), dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError):                    # not 4-byte aligned
        K.viterbi_acs(torch.zeros(81, dtype=torch.int8,
                                  device=cuda)[1:].view(2, 10, 4))
    with pytest.raises(ValueError):
        K.chainback(torch.zeros((10, 2), dtype=torch.int32, device=cuda))


def test_fic_and_msc_decode_on_cuda_match_cpu(cuda):
    rng = np.random.default_rng(1)
    payloads = [bytes(rng.integers(0, 256, 20).astype(np.uint8))
                for _ in range(12)]
    soft = _noisy(fic.FICEncoder(1).encode_fic(payloads), rng, 60.0)
    got = fic.FICDecoder(1, cuda).decode_fic(soft)
    ref = fic.FICDecoder(1).decode_fic(soft)
    assert got[0] == ref[0] and got[1]["crc_errors"] == ref[1]["crc_errors"]
    np.testing.assert_array_equal(got[1]["viterbi_error"],
                                  ref[1]["viterbi_error"])
    cfgs = [SubchannelConfig(0, 12, False, eep_type="A", eep_prot_level=2),
            SubchannelConfig(12, 12, False, eep_type="A", eep_prot_level=2)]
    encs = [msc.MSCEncoder(c) for c in cfgs]
    dg = [msc.MSCDecoder(c, cuda) for c in cfgs]
    dc = [msc.MSCDecoder(c) for c in cfgs]
    for _ in range(6):
        cifs = np.zeros((4, 864 * 64), np.int8)
        for k in range(4):
            for c, e in zip(cfgs, encs):
                pay = rng.integers(0, 256, e.nb_data_bytes).astype(np.uint8)
                a = e.encode_cif(pay.tobytes())
                cifs[k, c.start_address * 64:
                     c.start_address * 64 + a.shape[0]] = a
        cifs = _noisy(cifs, rng, 40.0)
        assert msc.decode_frame_group(dg, cifs) == \
            msc.decode_frame_group(dc, cifs)
    assert dg[0].history.device.type == "cuda"


def test_receive_chain_on_cuda_matches_cpu(cuda):
    tx = EnsembleTransmitter(1, services=[ServiceSpec(
        0xF123, 3, "Radio", SubchannelConfig(0, 12, False, eep_type="A",
                                             eep_prot_level=2))], device=cuda)
    iq = np.concatenate([np.zeros(7000, np.complex64), tx.generate(4),
                         np.zeros(7000, np.complex64)])
    rng = np.random.default_rng(2)
    n = np.arange(iq.shape[0])
    noise = rng.normal(size=(2, iq.shape[0])) * np.abs(iq).std() * 0.07
    iq = (iq * np.exp(2j * np.pi * 2.4 / 2048 * n) + noise[0] + 1j * noise[1]
          ).astype(np.complex64)
    sdg = StreamingDemodulator(OFDMDemodulator(1, device=cuda))
    sdc = StreamingDemodulator(OFDMDemodulator(1))
    fg, fc = sdg.process(iq), sdc.process(iq)
    assert len(fg) == len(fc) >= 3
    assert int(sdg.carry.total_desync) == int(sdc.carry.total_desync) == 0
    # cuFFT and the CPU FFT round differently: the carried CFO differs by
    # ulps, which the float32 PLL phase turns into 1-LSB soft-bit changes.
    # The noise spreads the soft values; on a noise-free signal they bunch
    # at one magnitude per symbol and flip together.
    diff = np.abs(np.stack(fg).astype(np.int16) - np.stack(fc))
    assert diff.max() <= 1 and (diff != 0).mean() <= 5e-3
