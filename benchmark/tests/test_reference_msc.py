"""The plain MSC reference (reference/msc.py) against the harness's own
coding and, on a card, against the timed fleet at the published widths.

- CPU: the frozen transmit chain's coded UEP bits (traffic/transmit.py,
  noiseless) decode back to the MP2 frames sent, and its EEP bits to the
  DAB+ superframes' logical frames.
- Card (marker `cuda`): mp2x9-fleet16.clean15db's fleet, at the cell's 16
  streams and 9 x 96 CU at UEP row 35, for a few rounds through the fleet
  driver; for stream 0 every MP2 frame after the cold 15 equals the
  reference's decode, on the card in float64, of the float64 reference
  demodulator's soft bits of those frames.
"""

import numpy as np
import pytest
import torch

from conftest import MIXED_SERVICES
from reference import msc
from traffic import standard as S
from traffic import transmit as T

MP2_CELL = "mp2x9-fleet16.clean15db"


def _subchannel(svc: T.Service, start: int = 0) -> msc.Subchannel:
    sub = svc.sub
    if sub.is_uep:
        return msc.Subchannel(start, sub.length, uep_index=sub.uep_table_index)
    return msc.Subchannel(start, sub.length,
                          eep=f"{sub.eep_prot_level + 1}-{sub.eep_type}")


def test_reference_decodes_the_harness_coding_back():
    mux = {"mode": 1, "ensemble_id": "C0FE", "ensemble_label": "TPU Ensemble",
           "services": MIXED_SERVICES}
    ens = T.ensemble_of(mux)
    rng = np.random.default_rng(2 ** 33 + 5)
    for svc in ens.services:
        groups = 24 if svc.kind == "dab" else 5
        units = T.random_units(svc, groups, rng)
        logical = T.logical_frames(svc, units)
        bits = T.msc_cif_bits(svc, logical, periodic=True)
        soft = np.where(bits > 0, 127, -127).astype(np.int8)
        got = msc.decode(soft, _subchannel(svc))
        want = [row.tobytes() for row in logical]
        assert len(got) == len(want) - (S.DEPTH - 1)
        assert got == want[:len(got)]
        if svc.kind == "dab":
            kbps = S.bitrate_kbps(svc.sub)
            assert svc.sub.uep_table_index == 35
            assert msc.mp2_frames(got, kbps) == [g[0] for g in units][
                :len(got)]


@pytest.mark.cuda
def test_fleet_mp2_frames_equal_the_reference_at_the_cells_size(cuda_card):
    from harness import spec
    from reference.check import FLEET_L1_START, _captures
    from reference.demod import Reference
    from traffic import generate
    cell = spec.cell(MP2_CELL)
    config = spec.config(cell["config"])
    traffic = generate.make(config["multiplex"], cell["traffic"],
                            2 ** 31 + 2020, "cuda")
    driver = spec.driver(config["driver"]).Driver(
        config, cell, traffic, "cuda", np.random.default_rng(20))
    rounds = 3
    for _ in range(rounds):
        driver.step()
    driver.finish()
    out = driver.outputs()
    driver.close()
    ens = traffic.ensemble
    svcs = ens.services
    assert len(svcs) == 9 and driver.N == 16
    assert all(s.sub.is_uep and s.sub.uep_table_index == 35
               and s.sub.length == 96 for s in svcs)
    K, fs = out["frames_per_round"], traffic.frame_samples
    frames = rounds * K
    ref = Reference(ens.mode, "cuda", "f64")
    tracks = [{"capture": out["capture_of"][0], "frames": frames,
               "mode": "grid", "start": out["start_bytes"][0] // 2,
               "l1": FLEET_L1_START}]
    _, bits, lost = ref.run(_captures(traffic, "cuda"), tracks,
                            [(0, f) for f in range(frames)])
    assert lost == [0]
    dab = S.dab_params(ens.mode)
    cifs = torch.as_tensor(np.stack(
        [bits[(0, f)][dab.nb_fic_bits:] for f in range(frames)]),
        device="cuda").reshape(-1, dab.nb_cif_bits)
    cold = S.DEPTH - 1
    for s, svc in enumerate(svcs):
        got = [a[3] for a in out["aus"] if a[0] == 0 and a[1] == s]
        assert len(got) == frames * dab.nb_cifs
        want = msc.mp2_frames(msc.decode(cifs, _subchannel(
            svc, svc.sub.start_address)), S.bitrate_kbps(svc.sub))
        assert len(want) == len(got) - cold
        assert got[cold:] == want, s
