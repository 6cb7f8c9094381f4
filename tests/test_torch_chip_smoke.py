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
    assert set(smoke.REPORT_SHAPE.values()) <= shapes
    assert K.plan(4, smoke.LONG_T)[0] == "pair"
    for _, B, T in smoke.K1_SHAPES:
        assert K.plan(B, T)[0] == "fused"


@pytest.mark.parametrize("B,T", [(4, 774), (72, 1542), (1152, 1542),
                                 (4, 41478)])
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
