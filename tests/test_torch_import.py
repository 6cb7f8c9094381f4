"""The PyTorch port never loads JAX: in a fresh interpreter, import every
module of the package and run its main path (transmitter -> u8 file ->
radio_cli on the CPU) for a few frames, then check sys.modules."""

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

    from dab_radio_tpu.host.native import iq_quantize_u8
    from dab_radio_tpu.params import SubchannelConfig
    from dab_radio_tpu_torch.apps import radio_cli
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
    assert "jax" not in sys.modules, "the main path loaded jax"
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
