"""Transmitter of the PyTorch port against the JAX package's: on the same
services and access-unit source, every frame's soft bits are identical and
the IQ agrees to float32 rounding of the two IFFTs and phase products.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dab_radio_tpu.dab.aac import SuperFrameHeader
from dab_radio_tpu.models.modulator import OFDMModulator as JMod
from dab_radio_tpu.models.transmitter import (EnsembleTransmitter as JTx,
                                              ServiceSpec as JSpec)
from dab_radio_tpu.params import SubchannelConfig, get_ofdm_params
from dab_radio_tpu_torch.models.modulator import OFDMModulator as TMod
from dab_radio_tpu_torch.models.transmitter import (EnsembleTransmitter as TTx,
                                                    ServiceSpec as TSpec)

torch.set_num_threads(1)


def _au_source(seed):
    state = {"i": 0}

    def make(cap, num):
        rng = np.random.default_rng(seed + state["i"])
        state["i"] += 1
        base = cap // num
        sizes = [base] * (num - 1) + [cap - base * (num - 1)]
        return [rng.integers(0, 256, n).astype(np.uint8).tobytes()
                for n in sizes]
    return make


def _services(Spec):
    return [
        Spec(0xF123, 3, "Plus", SubchannelConfig(0, 12, False, eep_type="A",
                                                 eep_prot_level=2),
             superframe_header=SuperFrameHeader(48000, True, True, False, 0)),
        Spec(0xF124, 4, "Classic", SubchannelConfig(12, 35, True,
                                                    uep_table_index=5),
             kind="dab"),
    ]


@pytest.mark.parametrize("mode", [1, 2])
def test_modulate_frame_matches_jax(mode):
    p = get_ofdm_params(mode)
    rng = np.random.default_rng(mode)
    bits = rng.integers(0, 2, (2, p.nb_data_symbols, 2 * p.nb_data_carriers)
                        ).astype(np.uint8)
    ref = np.asarray(JMod(mode).modulate_frame(jnp.asarray(bits)))
    got = TMod(mode).modulate_frame(bits).numpy()
    assert got.dtype == np.complex64 and got.shape == ref.shape
    # unit-power carriers summed by an unnormalised IFFT: |x| ~ 40, and
    # the cumulative phase products over 76 symbols differ by float32 ulps
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)
    stream = TMod(mode).modulate_stream(bits).numpy()
    np.testing.assert_array_equal(stream, got.reshape(-1))


def test_ensemble_transmitter_matches_jax():
    jtx, ttx = JTx(1, services=_services(JSpec)), TTx(1, services=_services(TSpec))
    jtx.set_au_source(3, _au_source(7))
    ttx.set_au_source(3, _au_source(7))
    for _ in range(3):
        jb, tb = jtx.next_frame_bits(), ttx.next_frame_bits()
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_allclose(ttx.modulate_frame_bits(tb),
                                   jtx.modulate_frame_bits(jb),
                                   rtol=0, atol=2e-3)
    assert ttx.generate(1).shape == (get_ofdm_params(1).nb_frame_samples,)


def test_tone_audio_sources_match_jax():
    specs_j, specs_t = _services(JSpec), _services(TSpec)
    jtx, ttx = JTx(1, services=specs_j), TTx(1, services=specs_t)
    jtx.enable_tone_audio()
    ttx.enable_tone_audio()
    np.testing.assert_array_equal(ttx.next_frame_bits(), jtx.next_frame_bits())
