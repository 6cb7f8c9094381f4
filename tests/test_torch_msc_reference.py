"""The port's MSC channel decode against the plain reference
``benchmark/reference/msc.py`` (EN 300 401: time deinterleave, EEP and UEP
depuncture, the K=7 Viterbi, energy dispersal), byte for byte.

The port's side is what the fused round runs (``parallel/mesh.py``): the
block deinterleave over the round's CIFs, ``MSCLanes``' padded depuncture,
K1 (its plain CPU route) at the round's common trellis length, the
descramble and the bit packing. Its input is seeded: random logical frames
coded by the port's MSCEncoder, with seeded noise that flips hard bits,
so that the decode corrects errors. The reference's tables are held
against the port's too, and the reference is checked to load neither the
port nor JAX.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dab_radio_tpu_torch.dab.msc import MSCEncoder
from dab_radio_tpu_torch.models.fused_fleet import _pack_bits
from dab_radio_tpu_torch.ops import viterbi as vit
from dab_radio_tpu_torch.ops.deinterleave import (deinterleave_push_block,
                                                  make_gather_index, DEPTH)
from dab_radio_tpu_torch.parallel.mesh import MSCLanes, common_trellis_steps
from dab_radio_tpu_torch.params import (SubchannelConfig,
                                        msc_puncture_schedule)
from dab_radio_tpu_torch.params import protection, puncture

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "benchmark", "reference", "msc.py")


def load_reference():
    spec = importlib.util.spec_from_file_location("plain_msc_reference",
                                                  REFERENCE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = load_reference()

# (id, the port's config, the reference's subchannel): every UEP level at
# 128 kbit/s (row 35 has 4 padding bits, row 37 has 8), two UEP rows at
# other bitrates (row 15 has no fourth segment), EEP-A, EEP-B and 2-A's
# 8-CU case
CASES = [
    ("uep33-128k-l5", SubchannelConfig(0, 64, True, 33),
     ref.Subchannel(0, 64, uep_index=33)),
    ("uep34-128k-l4", SubchannelConfig(0, 84, True, 34),
     ref.Subchannel(0, 84, uep_index=34)),
    ("uep35-128k-l3", SubchannelConfig(0, 96, True, 35),
     ref.Subchannel(0, 96, uep_index=35)),
    ("uep36-128k-l2", SubchannelConfig(0, 116, True, 36),
     ref.Subchannel(0, 116, uep_index=36)),
    ("uep37-128k-l1", SubchannelConfig(0, 140, True, 37),
     ref.Subchannel(0, 140, uep_index=37)),
    ("uep15-64k-l4", SubchannelConfig(0, 42, True, 15),
     ref.Subchannel(0, 42, uep_index=15)),
    ("uep62-384k-l3", SubchannelConfig(0, 280, True, 62),
     ref.Subchannel(0, 280, uep_index=62)),
    ("eep3a-48cu", SubchannelConfig(0, 48, False, 0, "A", 2),
     ref.Subchannel(0, 48, eep="3-A")),
    ("eep2b-42cu", SubchannelConfig(0, 42, False, 0, "B", 1),
     ref.Subchannel(0, 42, eep="2-B")),
    ("eep2a-8cu", SubchannelConfig(0, 8, False, 0, "A", 1),
     ref.Subchannel(0, 8, eep="2-A")),
]
FRAMES = 5                     # logical frames decoded whole
SIGMA = 50.0                   # noise on +/-127 soft bits: ~0.6% flipped


def coded_cifs(cfg: SubchannelConfig, seed: int):
    """(FRAMES + 15 CIFs of noisy int8 soft bits, the logical frames sent)."""
    enc = MSCEncoder(cfg)
    rng = np.random.default_rng(seed)
    sent = [rng.integers(0, 256, enc.nb_data_bytes, dtype=np.uint8).tobytes()
            for _ in range(FRAMES + DEPTH - 1)]
    clean = np.stack([enc.encode_cif(p) for p in sent]).astype(np.float64)
    noisy = np.clip(np.round(clean + rng.normal(0.0, SIGMA, clean.shape)),
                    -127, 127).astype(np.int8)
    flips = int(((noisy > 0) != (clean > 0))[clean != 0].sum())
    return noisy, sent, flips


def port_decode(cifs: np.ndarray, cfg: SubchannelConfig) -> list:
    """The fused round's decode of one subchannel's CIFs, from a cold
    deinterleaver: its logical frames from the 16th CIF on."""
    spec = vit.ViterbiSpec.from_schedule(msc_puncture_schedule(cfg))
    nb_steps = common_trellis_steps(spec.nb_steps)
    lanes = MSCLanes([[spec]], nb_steps, torch.device("cpu"))
    n_cifs, nb = cifs.shape
    hist = torch.zeros((1, 1, DEPTH, nb), dtype=torch.int8)
    idx = torch.as_tensor(make_gather_index(nb), dtype=torch.int64)
    _, deints = deinterleave_push_block(
        hist, torch.as_tensor(cifs)[None, None], idx)
    d = lanes.depuncture(deints).reshape(n_cifs, nb_steps, 4)
    bits, _ = vit.viterbi_decode_soft_radix4(d)
    bits = lanes.descramble(bits[:, :nb_steps - 6].reshape(1, 1, n_cifs, -1))
    packed = _pack_bits(bits)[0, 0].numpy()[:, :spec.nb_data_bits // 8]
    return [row.tobytes() for row in packed[DEPTH - 1:]]


@pytest.mark.parametrize("cfg,sub", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_port_msc_decode_equals_the_reference(cfg, sub):
    cifs, sent, flips = coded_cifs(cfg, seed=cfg.length * 1000
                                   + cfg.uep_table_index)
    assert flips > 0                         # the decode has errors to mend
    want = ref.decode(cifs, sub)
    assert len(want) == FRAMES
    assert ref.data_bits(sub) == 8 * len(want[0])
    assert port_decode(cifs, cfg) == want
    # the reference decodes what was sent, once the deinterleaver is full
    assert sum(w == s for w, s in zip(want, sent)) >= FRAMES - 1


def test_reference_tables_agree_with_the_port():
    """UEP rows, EEP profiles, the 24 puncturing vectors and the tail's
    vector: written out in the reference from EN 300 401, equal to the
    port's params/ (the reference lists no difference in
    PORT_DIFFERENCES), and each UEP row's coded bits and padding fill its
    subchannel."""
    assert ref.PORT_DIFFERENCES == {}
    assert len(ref.UEP_TABLE) == len(protection.UEP_TABLE) == 64
    for i, row in enumerate(ref.UEP_TABLE):
        p = protection.UEP_TABLE[i]
        assert row == (p.subchannel_size, p.bitrate_kbps, p.protection_level,
                       p.Lx, p.PIx, p.padding_bits), i
        sub = ref.Subchannel(0, row[0], uep_index=i)
        segs, padding = ref.segments(sub)
        assert padding == row[5]
        assert ref.data_bits(sub) == row[1] * 24        # 24 ms of the rate
    for k in range(1, 25):
        assert (ref._vector(ref.PUNCTURING_VECTORS[k])
                == puncture.get_puncture_vector(k)).all(), k
    assert (ref._vector(ref.TAIL_VECTOR) == puncture.PI_X_VECTOR).all()
    for kind, table in (("A", protection.EEP_TABLE_A),
                        ("B", protection.EEP_TABLE_B)):
        mine = ref.EEP_A if kind == "A" else ref.EEP_B
        for level, p in enumerate(table, start=1):
            assert mine[level] == (p.capacity_unit_multiple, p.L1_eq,
                                   p.L2_eq, p.PIx, p.bitrate_multiple)
    p = protection.EEP_PROFILE_2A_N1
    assert ref.EEP_2A_N1 == (p.capacity_unit_multiple, p.L1_eq, p.L2_eq,
                             p.PIx, p.bitrate_multiple)
    assert tuple(ref.POLYNOMIALS_OCTAL) == vit.POLYS
    for poly, delays in zip(ref.POLYNOMIALS_OCTAL, ref.TAP_DELAYS):
        assert poly == sum(1 << (6 - d) for d in delays)
    from dab_radio_tpu_torch.ops.deinterleave import CIF_OFFSETS
    from dab_radio_tpu_torch.ops.scrambler import prbs_bits
    assert tuple(CIF_OFFSETS) == ref.CIF_DELAYS
    assert (ref.prbs(3072) == prbs_bits(3072)).all()


def test_reference_splits_mp2_frames_at_48_khz():
    frames = [bytes(384), bytes(range(256)) + bytes(128)]
    assert ref.mp2_frames(frames, 128) == frames
    with pytest.raises(ValueError, match="no MP2 frame"):
        ref.mp2_frames([bytes(383)], 128)
    with pytest.raises(ValueError, match="48 kHz"):
        ref.mp2_frames(frames, 128, sampling_rate=24000)


def test_reference_refuses_a_wrong_size():
    with pytest.raises(ValueError, match="not 90"):
        ref.segments(ref.Subchannel(0, 90, uep_index=35))
    with pytest.raises(ValueError, match="multiples of 6"):
        ref.segments(ref.Subchannel(0, 50, eep="3-A"))


def test_reference_imports_neither_the_port_nor_jax():
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('m', {REFERENCE!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'dab_radio_tpu', 'dab_radio_tpu_torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
