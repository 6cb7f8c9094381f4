"""What chip_smoke.py promises without a card, and the arithmetic it prints:
it must fail, printing no result, where there is no GPU, also when it is
run alone in a directory of its own; its roofline bounds follow from the
shapes; and it reports every kernel whose launches the wrappers count.
"""

import importlib.util
import os
import shutil
import subprocess
import sys

import pytest
import torch

from dab_radio_tpu_torch.kernels import viterbi_acs as K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("alone", [False, True])
def test_fails_and_prints_no_result_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("there is a card: the script would run")
    script, cwd = SCRIPT, ROOT
    if alone:
        script = shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
        cwd = tmp_path
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, cwd=cwd, timeout=300,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
    assert "no CUDA device" in res.stderr


def test_every_counted_kernel_is_reported(smoke):
    assert set(smoke.REPLACES) == set(K.LAUNCHES) == set(smoke.REPORT_SHAPE) \
        == set(smoke.KERNEL_PATH)
    shapes = {name for name, _, _ in smoke.K1_SHAPES} | {"eep4a_864cu"}
    assert set(smoke.WINDOWS_OF) <= shapes
    assert set(smoke.REPORT_SHAPE.values()) <= shapes | set(
        smoke.WINDOWS_OF.values())
    assert K.plan(4, smoke.LONG_T)[0] == "pair"
    for _, B, T in smoke.K1_SHAPES:
        assert K.plan(B, T)[0] == "fused"
    # each kernel's path is one whose launches the script reads
    assert set(smoke.KERNEL_PATH.values()) <= {"main", "long", "fleet",
                                               "fleet_tiled"}
    assert smoke.launched(viterbi_acs=2) == dict(
        dict.fromkeys(K.LAUNCHES, 0), viterbi_acs=2)


def test_window_shapes_of_the_tiled_decode(smoke):
    """The windowed entry's four shapes follow from the exact shapes: ceil(T
    / 128) windows of 320 steps a message; the fleet round's 126,464 plan as
    16 a block; the bounds are those of 285 operations a window step."""
    from dab_radio_tpu_torch.ops import viterbi as vit
    lanes = {name: (B, T) for name, B, T in smoke.K1_SHAPES}
    lanes["eep4a_864cu"] = (4, smoke.LONG_T)
    nb = {smoke.WINDOWS_OF[n]: B * -(-T // 128) for n, (B, T) in lanes.items()
          if n in smoke.WINDOWS_OF}
    assert nb == {"fic_tiled": 28, "msc_group_tiled": 936, "long_tiled": 1300,
                  "round16x8_tiled": 126464}
    w, first = vit.tile_windows(torch.zeros((4, 774, 4), dtype=torch.int8))
    assert tuple(w.shape) == (28, smoke.WINDOW_L, 4) and int(first.sum()) == 4
    assert K.plan(126464, 320) == ("fused", 16, 6976)
    assert smoke.REPORT_SHAPE["viterbi_decode_windows"] == "round16x8_tiled"
    for B, want in ((1300, 0.0071), (126464, 0.689)):
        ms, by = smoke.bound("viterbi_decode_windows", B, 320)
        assert by == "operations" and ms == pytest.approx(want, rel=5e-3)
        assert ms == pytest.approx(smoke.bound("viterbi_decode_fused", B,
                                               320)[0])
    # the plain version is compared in chunks that fit the card's memory
    assert 126464 % smoke.WINDOW_PLAIN_CHUNK == 0
    assert 3 * smoke.WINDOW_PLAIN_CHUNK * 320 * 128 * 4 < 8e9
    assert smoke.VARIANT_STREAMS * (18 * 4 + 4) * smoke.VARIANT_K == 608


def test_fleet_rounds_shape(smoke):
    """The fleet path's one decode a round: 16 streams x (18 subchannels x
    32 CIFs + 32 FIC groups) messages of 1542 steps, which plans as the
    fused kernel with 12 messages a block; its bound is 0.2556 ms, by
    operations; the fused kernel is reported at that shape."""
    assert smoke.FLEET_LANES == 9728
    assert ("round16x8", 9728, 1542) in smoke.K1_SHAPES
    assert smoke.REPORT_SHAPE["viterbi_decode_fused"] == "round16x8"
    assert smoke.KERNEL_PATH["viterbi_decode_fused"] == "fleet"
    route, per_block, smem = K.plan(9728, 1542)
    assert (route, per_block, smem) == ("fused", 12, 17984)
    assert -(-9728 // per_block) == 811
    ms, by = smoke.bound("viterbi_decode_fused", 9728, 1542)
    assert by == "operations" and ms == pytest.approx(0.2556, abs=5e-5)
    # the plain version is compared in chunks that fit the card's memory
    assert 3 * smoke.PLAIN_CHUNK * 1542 * 128 * 4 < 8e9
    assert (smoke.NB_FRAMES - 1) // smoke.FLEET_K == 3


@pytest.mark.parametrize("B,T", [(4, 774), (72, 1542), (1152, 1542),
                                 (9728, 1542), (4, 41478)])
def test_roofline_bounds_follow_from_the_shape(smoke, B, T):
    steps = B * T
    fused_ms, fused_by = smoke.bound("viterbi_decode_fused", B, T)
    acs_ms, acs_by = smoke.bound("viterbi_acs", B, T)
    cb_ms, cb_by = smoke.bound("viterbi_chainback", B, T)
    # 280 int32 operations a step against 16.7 T op/s outweigh 12 bytes a
    # step against 3.35 TB/s; the chainback's 5 operations do not
    assert (fused_by, acs_by, cb_by) == ("operations", "operations", "bytes")
    assert acs_ms == pytest.approx(280 * steps / (132 * 64 * 1.98e9) * 1e3)
    assert fused_ms == pytest.approx(285 * steps / (132 * 64 * 1.98e9) * 1e3)
    assert cb_ms == pytest.approx(9 * steps / 3.35e12 * 1e3)
    assert fused_ms > acs_ms > cb_ms > 0
