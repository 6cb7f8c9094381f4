"""The port's serving soak, ``dab_radio_tpu_torch.tools.soak``, in process on
the CPU: a short soak passes with the JSON keys of ``tools/soak.py`` (read
from its source: running the JAX soak would double the time), and the gate
fails when RSS grows past --max-rss-growth.

The capture is the port's transmitter's (2 services, 40 mode-I frames),
made once into this module's temporary directory.
"""

import ast
import json
import os
import tempfile

import pytest

from dab_radio_tpu_torch.tools import soak

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--streams", "1", "--services", "2", "--frames-per-step", "2",
         "--backend", "cpu"]


def _jax_keys():
    """(keys of the result line, keys of a sample) in tools/soak.py."""
    with open(os.path.join(ROOT, "tools", "soak.py")) as f:
        tree = ast.parse(f.read())
    dicts = [n for n in ast.walk(tree) if isinstance(n, ast.Dict)
             and n.keys and all(isinstance(k, ast.Constant) for k in n.keys)]
    keys = [{k.value for k in d.keys} for d in dicts]
    result = next(k for k in keys if "metric" in k)
    sample = next(k for k in keys if "rss_mb" in k)
    return result, sample


@pytest.fixture(scope="module")
def tmpdir_with_capture(tmp_path_factory):
    """The temporary directory the soak caches its capture in."""
    return str(tmp_path_factory.mktemp("soak"))


def _soak(argv, monkeypatch, capsys, tmp):
    monkeypatch.setattr(tempfile, "tempdir", tmp)
    capsys.readouterr()
    rc = soak.main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_soak_passes_with_the_jax_keys(tmpdir_with_capture, monkeypatch,
                                       capsys):
    rc, res = _soak(["--seconds", "8", "--sample-s", "2", *SMALL],
                    monkeypatch, capsys, tmpdir_with_capture)
    assert rc == 0 and res["ok"] is True
    assert os.path.exists(os.path.join(tmpdir_with_capture,
                                       "torch_soak_iq_s2_f40.u8"))
    result_keys, sample_keys = _jax_keys()
    assert set(res) == result_keys
    assert res["samples"] and all(set(x) == sample_keys
                                  for x in res["samples"])
    assert res["metric"] == "serving_soak" and res["streams"] == 1
    assert res["total_aus"] > 0 and res["samples"][-1]["au_rate"] > 0
    assert res["rss_growth"] <= 0.15


def test_soak_fails_when_rss_grows(tmpdir_with_capture, monkeypatch, capsys):
    """A stubbed RSS that grows by half at every sample: rc 1, ok false,
    while access units are decoded (the RSS gate is what fails)."""
    rss = iter(1000.0 * 1.5 ** k for k in range(10_000))
    monkeypatch.setattr(soak, "_rss_mb", lambda: next(rss))
    rc, res = _soak(["--seconds", "5", "--sample-s", "1", *SMALL],
                    monkeypatch, capsys, tmpdir_with_capture)
    assert rc == 1 and res["ok"] is False
    assert res["rss_growth"] > 0.15
    assert len(res["samples"]) >= 2 and res["total_aus"] > 0
