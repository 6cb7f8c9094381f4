"""The PyTorch port loads neither JAX nor the JAX package: in a fresh
interpreter, import every module of the package and run its main path
(transmitter -> u8 file -> radio_cli, then fleet_serve, each also with the
decode variants, then MultiStreamDemodulator into ReceiverFleet, on the CPU)
for a few frames, then check sys.modules; and no source file of the port
imports either."""

import ast
import glob
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, os, pkgutil, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import dab_radio_tpu_torch
    for m in pkgutil.walk_packages(dab_radio_tpu_torch.__path__,
                                   "dab_radio_tpu_torch."):
        importlib.import_module(m.name)
    assert "jax" not in sys.modules, "import loaded jax"

    from dab_radio_tpu_torch.host.native import iq_quantize_u8
    from dab_radio_tpu_torch.params import SubchannelConfig
    from dab_radio_tpu_torch.apps import fleet_serve, radio_cli
    from dab_radio_tpu_torch.models.transmitter import (EnsembleTransmitter,
                                                        ServiceSpec)
    tx = EnsembleTransmitter(1, services=[ServiceSpec(
        0xF123, 3, "Radio", SubchannelConfig(0, 12, False, eep_type="A",
                                             eep_prot_level=2))])
    iq = np.concatenate([np.zeros(5000, np.complex64), tx.generate(2),
                         np.zeros(5000, np.complex64)])
    path = sys.argv[1]
    with open(path, "wb") as f:
        f.write(iq_quantize_u8(iq / np.abs(iq).max() * 0.5))
    assert radio_cli.main(["-i", path, "-F", "u8", "--backend", "cpu"]) == 0
    assert fleet_serve.main(["-i", path, "--shared-input", "--streams", "2",
                             "--subchannels", "0:12:EEP3A",
                             "--frames-per-step", "1", "--prefetch", "1",
                             "--backend", "cpu"]) == 0
    assert radio_cli.main(["-i", path, "-F", "u8", "--backend", "cpu",
                           "--viterbi", "tiled"]) == 0
    assert radio_cli.main(["-i", path, "-F", "u8", "--backend", "cpu"]) == 0
    assert fleet_serve.main(["-i", path, "--subchannels", "0:12:EEP3A",
                             "--frames-per-step", "1", "--viterbi", "tiled",
                             "--chainback", "parallel", "--backend",
                             "cpu"]) == 0
    from dab_radio_tpu_torch.models.demodulator import OFDMDemodulator
    from dab_radio_tpu_torch.models.fleet import ReceiverFleet
    from dab_radio_tpu_torch.models.multistream import MultiStreamDemodulator
    ms = MultiStreamDemodulator(OFDMDemodulator(1), 1, ingest="u8",
                                fetch_bits=False, device="cpu")
    fleet = ReceiverFleet(1, 1, pipeline_depth=1, device="cpu")
    ms.push(0, np.fromfile(path, np.uint8))
    for frames in iter(ms.step, []):
        fleet.process_frames(frames)
    fleet.flush()
    assert fleet.summary()["frames"] == 2 and fleet.receivers[0].db.services
    assert "jax" not in sys.modules, "the main path loaded jax"
    loaded = [m for m in sys.modules
              if m == "dab_radio_tpu" or m.startswith("dab_radio_tpu.")]
    assert not loaded, f"the port loaded the JAX package: {loaded}"
    print("NO_JAX_OK")
""")


def test_port_never_loads_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", SCRIPT,
                          str(tmp_path / "cap.u8")],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout
    assert "ensemble: id=C0FE" in res.stderr
    assert "demod: frames_read=2 desync=0" in res.stderr
    assert '"ensemble": "C0FE"' in res.stdout and '"rounds": 2' in res.stdout


def _imported_modules(path):
    """Top-level names of every module a source file imports, at any depth
    of the file (lazy imports inside functions included)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_sources_import_neither_jax_nor_the_jax_package():
    sources = glob.glob(os.path.join(ROOT, "dab_radio_tpu_torch", "**", "*.py"),
                        recursive=True)
    sources.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(sources) > 60
    for path in sources:
        bad = _imported_modules(path) & {"jax", "jaxlib", "dab_radio_tpu"}
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {sorted(bad)}"
