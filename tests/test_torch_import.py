"""The PyTorch port loads neither JAX nor the JAX package: in a fresh
interpreter, import every module of the package and run its main path
(transmitter -> u8 file -> radio_cli, then fleet_serve, each also with the
decode variants, then MultiStreamDemodulator into ReceiverFleet, then
simulate_transmitter, ber_sweep and radio_app, then the monitors tui,
monitor and webmon's plot and state, and rs_syndromes_device, on the CPU)
for a few frames, with the captured programs of utils/graphs.py running
eagerly there, then check sys.modules; the same in every rank of the
mesh dry run (``parallel/dryrun.py``, two gloo ranks on the CPU); and no
source file of the port imports either."""

import ast
import glob
import json
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
    # the captured programs (utils/graphs.py) run eagerly on the CPU
    from dab_radio_tpu_torch.utils.graphs import CapturedProgram
    prog = CapturedProgram(torch.neg, "cpu")
    assert not prog.captured and torch.equal(prog(torch.ones(2)),
                                             -torch.ones(2))

    from dab_radio_tpu_torch.host.native import iq_quantize_u8
    from dab_radio_tpu_torch.params import SubchannelConfig
    from dab_radio_tpu_torch.apps import fleet_serve, radio_cli
    from dab_radio_tpu_torch.models.transmitter import (EnsembleTransmitter,
                                                        ServiceSpec)
    tx = EnsembleTransmitter(1, services=[ServiceSpec(
        0xF123, 3, "Radio", SubchannelConfig(0, 12, False, eep_type="A",
                                             eep_prot_level=2))],
        device="cpu")
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
    from dab_radio_tpu_torch.models.demodulator import (OFDMDemodulator,
                                                        StreamingDemodulator)
    from dab_radio_tpu_torch.models.fleet import ReceiverFleet
    from dab_radio_tpu_torch.models.receiver import DabReceiver
    from dab_radio_tpu_torch.models.multistream import MultiStreamDemodulator
    ms = MultiStreamDemodulator(OFDMDemodulator(1, device="cpu"), 1,
                                ingest="u8", fetch_bits=False, device="cpu")
    fleet = ReceiverFleet(1, 1, pipeline_depth=1, device="cpu")
    ms.push(0, np.fromfile(path, np.uint8))
    for frames in iter(ms.step, []):
        fleet.process_frames(frames)
    fleet.flush()
    assert fleet.summary()["frames"] == 2 and fleet.receivers[0].db.services
    import io
    from dab_radio_tpu_torch.apps import (ber_sweep, radio_app,
                                          simulate_transmitter)
    real, sys.stdout = sys.stdout, io.TextIOWrapper(io.BytesIO())
    assert simulate_transmitter.main(["--payload", "random", "-n", "1",
                                      "-M", "2", "--backend", "cpu"]) == 0
    assert ber_sweep.main(["-M", "2", "--snr", "14", "-n", "2",
                           "--backend", "cpu"]) == 0
    sys.stdout = real
    assert radio_app.main(["--device", "file", "-i", path, "--audio-out", "",
                           "--backend", "cpu"]) == 0
    from dab_radio_tpu_torch.apps import monitor, tui, webmon
    from dab_radio_tpu_torch.ops.rs import rs_syndromes_device
    sys.stdout = io.TextIOWrapper(io.BytesIO())
    assert tui.main(["-i", path, "--plain", "--backend", "cpu"]) == 0
    sys.stdout = real
    assert monitor.main(["-i", path, "--frames", "1", "-o",
                         path + ".png", "--backend", "cpu"]) == 0
    st = webmon._State()
    st.demod = OFDMDemodulator(1, device="cpu")
    st.sd = StreamingDemodulator(st.demod)
    st.rx = DabReceiver(1, device="cpu")
    from dab_radio_tpu_torch.host.native import iq_convert
    for bits in st.sd.process(iq_convert(open(path, "rb").read(), "u8")):
        st.rx.process_frame(bits)
    assert b"impulse_db" in webmon._plot_json(st)
    assert b"C0FE" in webmon._state_json(st)
    cw = torch.zeros((2, 120), dtype=torch.uint8)
    assert not rs_syndromes_device(cw, 10, 135).any()
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


def test_mesh_ranks_never_load_jax(tmp_path):
    """Each rank of the dry run over (1, 1, 2) lists the modules of jax and
    of the JAX package in its sys.modules after its round: none."""
    from dab_radio_tpu_torch.parallel import dryrun
    init = f"file://{tmp_path}/rdzv"
    outs = dryrun.launch([dryrun.rank_command(r, 2, init, (1, 1, 2), "cpu",
                                              frames=17) for r in range(2)],
                         240, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert [rc for rc, _ in outs] == [0, 0], outs
    line, = [ln for ln in outs[0][1].splitlines() if ln.startswith("dryrun: ")]
    report = json.loads(line[len("dryrun: "):])
    assert report["bit_exact"] and len(report["ranks"]) == 2
    assert [r["loaded_jax"] for r in report["ranks"]] == [[], []]


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


def _device_defaults():
    """(qualified name, default) of every parameter named device that has a
    default, over the public classes (their methods included) and functions
    of every module of the port."""
    import importlib
    import inspect
    import pkgutil
    import dab_radio_tpu_torch
    found = []

    def visit(name, fn):
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):
            return
        p = sig.parameters.get("device")
        if p is not None and p.default is not inspect.Parameter.empty:
            found.append((name, p.default))

    for m in pkgutil.walk_packages(dab_radio_tpu_torch.__path__,
                                   "dab_radio_tpu_torch."):
        mod = importlib.import_module(m.name)
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__", None) \
                    != mod.__name__:
                continue
            if inspect.isclass(obj):
                for attr, member in vars(obj).items():
                    if attr.startswith("_") and attr != "__init__":
                        continue
                    if isinstance(member, (classmethod, staticmethod)):
                        member = member.__func__
                    if inspect.isfunction(member):
                        visit(f"{mod.__name__}.{name}.{attr}", member)
            elif inspect.isfunction(obj):
                visit(f"{mod.__name__}.{name}", obj)
    return found


def test_no_public_signature_defaults_to_the_cpu():
    """A caller who names no device gets an error, never the CPU: no public
    constructor, method or function of the port has a device parameter
    whose default resolves to the CPU (None, where a function documents it
    as its rank's card, is no CPU; an ALSA device name is no torch
    device)."""
    import torch

    def cpu(d):
        try:
            return d is not None and torch.device(d).type == "cpu"
        except RuntimeError:
            return False
    found = _device_defaults()
    assert ("dab_radio_tpu_torch.host.audio.AlsaSink.__init__", "default") \
        in found
    bad = [(name, d) for name, d in found if cpu(d)]
    assert not bad, f"device defaults to the CPU in {bad}"
    # the walk reaches the constructors that once had such a default
    from dab_radio_tpu_torch.models.demodulator import OFDMDemodulator
    import inspect
    p = inspect.signature(OFDMDemodulator).parameters["device"]
    assert p.default is inspect.Parameter.empty
