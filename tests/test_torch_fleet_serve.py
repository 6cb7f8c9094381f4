"""The serving CLI: ``dab_radio_tpu_torch.apps.fleet_serve`` on ``--backend
cpu`` against the JAX package's ``fleet_serve`` on the same capture. The
JSON lines on stdout (one a stream: ensemble, services, ``fib_ok``,
``drift``; then the fleet's totals) must be equal.

Captures are small mode-II ensembles (``-M 2``, two DAB+ subchannels of
12 CU) from the JAX transmitter with a carrier offset and noise, behind a
few thousand samples of silence so that the cold-start alignment has work
to do.
"""

import io
import json
import os
import socket
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dab_radio_tpu.apps import fleet_serve as jserve
from dab_radio_tpu.dab.aac import SuperFrameHeader
from dab_radio_tpu.host.native import iq_quantize_u8
from dab_radio_tpu.models.channel import ChannelModel
from dab_radio_tpu.models.transmitter import EnsembleTransmitter, ServiceSpec
from dab_radio_tpu.params import SubchannelConfig as JCfg
from dab_radio_tpu_torch.apps import fleet_serve as tserve

torch.set_num_threads(1)

FS = 49152                       # samples of a mode-II frame
HDR = SuperFrameHeader(48000, True, True, False, 0)
EEP3A = dict(is_uep=False, eep_type="A", eep_prot_level=2)
LAYOUT = "0:12:EEP3A,12:12:EEP3A"
BASE = ["-M", "2", "--frames-per-step", "4", "--backend", "cpu"]


def _au_source(seed):
    rng = np.random.default_rng(seed)

    def make(cap, num):
        base = cap // num
        sizes = [base] * (num - 1) + [cap - base * (num - 1)]
        return [rng.integers(0, 256, n).astype(np.uint8).tobytes()
                for n in sizes]
    return make


def _capture(ensemble_id, label, cfo_hz, seed, nb_frames=41, lead=7000):
    services = [ServiceSpec(0xF300 + 16 * seed + i, i + 1, f"{label} {i}",
                            JCfg(12 * i, 12, **EEP3A), superframe_header=HDR)
                for i in range(2)]
    tx = EnsembleTransmitter(2, ensemble_id=ensemble_id, ensemble_label=label,
                             services=services)
    for s in services:
        tx.set_au_source(s.subchannel_id, _au_source(s.service_id))
    pad = np.zeros(lead, np.complex64)
    iq = np.concatenate([pad, tx.generate(nb_frames), pad])
    iq = ChannelModel(cfo_hz=cfo_hz, snr_db=18.0, seed=seed,
                      snr_ref=(lead, iq.shape[0] - lead)).apply(iq)
    return np.frombuffer(iq_quantize_u8(
        (iq / np.abs(iq).max() * 0.5).astype(np.complex64)), np.uint8)


@pytest.fixture(scope="module")
def caps(tmp_path_factory):
    """Two captures of different ensembles, as arrays and as files."""
    root = tmp_path_factory.mktemp("fleet_serve")
    arrays = [_capture(0xC0FE, "Serve", 1300.0, 1),
              _capture(0xBEEF, "Other", -800.0, 2)]
    paths = []
    for k, a in enumerate(arrays):
        paths.append(str(root / f"cap{k}.u8"))
        a.tofile(paths[-1])
    return types.SimpleNamespace(arrays=arrays, paths=paths, root=root)


def run_cli(mod, argv, capsys, monkeypatch, stdin: bytes = None):
    """mod.main(argv) in this process -> (return code, stdout JSON lines,
    stderr text)."""
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin",
                            types.SimpleNamespace(buffer=io.BytesIO(stdin)))
    capsys.readouterr()
    rc = mod.main(argv)
    out = capsys.readouterr()
    return rc, [json.loads(ln) for ln in out.out.splitlines()], out.err


def both(argv, capsys, monkeypatch, stdin=None):
    """Run the JAX CLI and the port's on argv; the port's lines, after
    checking them equal to the JAX CLI's."""
    jrc, jlines, _ = run_cli(jserve, argv, capsys, monkeypatch, stdin)
    trc, tlines, terr = run_cli(tserve, argv, capsys, monkeypatch, stdin)
    assert trc == jrc == 0
    assert tlines == jlines
    return tlines, terr


def test_shared_input_static_layout(caps, capsys, monkeypatch):
    lines, _ = both(["-i", caps.paths[0], "--shared-input", "--streams", "3",
                     "--subchannels", LAYOUT, *BASE], capsys, monkeypatch)
    assert len(lines) == 4
    for k, row in enumerate(lines[:3]):
        assert row["stream"] == k and row["ensemble"] == "C0FE"
        assert row["label"] == "Serve" and len(row["services"]) == 2
        assert row["fib_ok"] > 0
    total = lines[3]
    assert total["streams"] == 3 and total["rounds"] == 10
    assert total["frames"] == 120 and total["services"] == 6
    assert total["access_units"] >= 3 * 2 * 3 * 4


def test_discover_per_stream_files(caps, capsys, monkeypatch):
    lines, _ = both(["-i", *caps.paths, "--discover", *BASE],
                    capsys, monkeypatch)
    assert [row["ensemble"] for row in lines[:2]] == ["C0FE", "BEEF"]
    assert [row["label"] for row in lines[:2]] == ["Serve", "Other"]
    assert lines[2]["streams"] == 2 and lines[2]["access_units"] > 0


def test_discover_shared_input(caps, capsys, monkeypatch):
    lines, _ = both(["-i", caps.paths[1], "--shared-input", "--streams", "2",
                     "--discover", *BASE], capsys, monkeypatch)
    assert [row["ensemble"] for row in lines[:2]] == ["BEEF", "BEEF"]
    assert lines[2]["access_units"] > 0


def test_live_stdin(caps, capsys, monkeypatch):
    data = caps.arrays[0].tobytes()
    lines, _ = both(["-i", "-", "--streams", "2", "--discover", *BASE],
                    capsys, monkeypatch, stdin=data)
    assert len(lines) == 3 and lines[0]["ensemble"] == "C0FE"
    assert lines[2]["streams"] == 2 and lines[2]["access_units"] > 0
    # the same stream from a file gives the same totals
    flines, _ = run_cli(tserve, ["-i", caps.paths[0], "--shared-input",
                                 "--streams", "2", "--discover", *BASE],
                        capsys, monkeypatch)[1:]
    assert flines[2] == lines[2]
    rc, out, err = run_cli(tserve, ["-i", "-", "-F", "s16le", *BASE], capsys,
                           monkeypatch, stdin=b"")
    assert rc == 2 and not out and "u8 only" in err


@pytest.mark.parametrize("dup", [300, 600])
def test_drift_reanchor(caps, tmp_path, capsys, monkeypatch, dup):
    """`dup` samples played twice after 12 frames push the frame grid off
    the round grid: the serving loop follows the fine-time offset, reports
    the correction and keeps decoding. 300 samples cost no access unit; 600
    are near the +638 samples a mode-II window absorbs, and cost some."""
    iq = caps.arrays[0]
    X = 2 * (7000 + 12 * FS)
    path = tmp_path / "drift.u8"
    np.concatenate([iq[:X], iq[X - 2 * dup:X], iq[X:]]).tofile(path)
    argv = ["-i", str(path), "--subchannels", LAYOUT, *BASE]
    lines, _ = both(argv, capsys, monkeypatch)
    total = lines[-1]
    assert abs(sum(total["drift_corrected_samples"]) - dup) <= 20, total
    clean = run_cli(tserve, ["-i", caps.paths[0], "--subchannels", LAYOUT,
                             *BASE], capsys, monkeypatch)[1][-1]
    assert "drift_corrected_samples" not in clean
    if dup == 300:
        assert total["access_units"] == clean["access_units"] >= 24
    else:
        assert 0 < total["access_units"] < clean["access_units"]
    # the staged rounds are dropped and read again when the grid moves
    plines = run_cli(tserve, argv + ["--prefetch", "2"], capsys,
                     monkeypatch)[1]
    assert plines == lines


def test_desync_reacquire(caps, tmp_path, capsys, monkeypatch):
    """A noise burst, then the signal again at another alignment (a retune):
    dead FIBs, resync of the device state, a new frame grid, decoding
    resumes."""
    iq = caps.arrays[0]
    fb = 2 * FS
    rng = np.random.default_rng(3)
    noise = rng.integers(0, 256, 14 * fb).astype(np.uint8)
    path = tmp_path / "retune.u8"
    np.concatenate([iq[:14000 + 12 * fb], noise,
                    iq[14000 + 3 * fb + 2 * 7777:]]).tofile(path)
    lines, err = both(["-i", str(path), "--subchannels", LAYOUT, *BASE],
                      capsys, monkeypatch)
    assert lines[-1]["resync_events"] >= 1 and "re-acquiring" in err
    assert lines[0]["fib_ok"] > 0 and lines[-1]["access_units"] > 0


def test_snapshot_and_resume(caps, tmp_path, capsys, monkeypatch):
    """--max-rounds 4 --snapshot-out, then --resume: the totals of one
    uninterrupted run, in the port as in the JAX CLI."""
    argv = ["-i", caps.paths[0], "--shared-input", "--streams", "2",
            "--subchannels", LAYOUT, *BASE]
    full, _ = both(argv, capsys, monkeypatch)
    snaps = {}
    for name, mod in (("jax", jserve), ("torch", tserve)):
        snap = str(tmp_path / f"{name}.snap")
        rc, head, err = run_cli(mod, argv + ["--max-rounds", "4",
                                             "--snapshot-out", snap],
                                capsys, monkeypatch)
        assert rc == 0 and head[-1]["rounds"] == 4 and "snapshot written" in err
        rc, rest, err = run_cli(mod, argv + ["--resume", snap],
                                capsys, monkeypatch)
        assert rc == 0 and "resumed from" in err
        snaps[name] = (head, rest)
    assert snaps["torch"] == snaps["jax"]
    assert snaps["torch"][1] == full
    with pytest.raises(ValueError, match="2 streams"):
        tserve.main(["-i", caps.paths[0], "--resume",
                     str(tmp_path / "torch.snap"), *BASE])


@pytest.mark.parametrize("extra", [["--prefetch", "2"],
                                   ["--prefetch", "1", "--max-rounds", "3"]],
                         ids=["prefetch", "prefetch_cut"])
def test_options_do_not_change_the_output(caps, capsys, monkeypatch, extra):
    argv = ["-i", *caps.paths, "--subchannels", LAYOUT, *BASE]
    if "--max-rounds" in extra:
        argv += ["--max-rounds", "3"]
    want = run_cli(tserve, argv, capsys, monkeypatch)[1]
    got = run_cli(tserve, argv + extra, capsys, monkeypatch)[1]
    assert got == want and got[-1]["access_units"] >= 0
    assert got[-1]["rounds"] == (3 if "--max-rounds" in extra else 10)
    assert not [t for t in threading.enumerate()
                if t.name == "ingest-feeder" and t.is_alive()]


def test_scraper_output_and_audio_flag(caps, tmp_path, capsys, monkeypatch):
    out = tmp_path / "scrape"
    lines, _ = both(["-i", caps.paths[0], "--subchannels", LAYOUT,
                     "--scraper-output", str(out), *BASE],
                    capsys, monkeypatch)
    for s in (0, 1):
        f = out / "stream_0" / f"subchannel_{s}" / "stream.aac"
        assert f.exists() and f.stat().st_size > 500
    # --audio adds pcm_samples to the totals (0 here: the seeded access
    # units are random bytes, or no codec library is present)
    total = run_cli(tserve, ["-i", caps.paths[0], "--subchannels", LAYOUT,
                             "--audio", "0:0", *BASE], capsys,
                    monkeypatch)[1][-1]
    assert total["pcm_samples"] >= 0
    assert {k: v for k, v in total.items() if k != "pcm_samples"} == lines[-1]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_status_port_serves_state_json(caps, capsys, monkeypatch):
    """--port: /state.json while a live stream is being served, and
    /plot.json?stream=1: 503 with Retry-After until a round after the first
    request has built the plot, then stream 1's OFDM plots."""
    port = _free_port()
    rfd, wfd = os.pipe()
    monkeypatch.setattr(sys, "stdin", types.SimpleNamespace(
        buffer=os.fdopen(rfd, "rb")))
    result = {}
    argv = ["-i", "-", "--streams", "2", "--subchannels", LAYOUT,
            "--port", str(port), *BASE]
    th = threading.Thread(target=lambda: result.setdefault(
        "rc", tserve.main(argv)))
    capsys.readouterr()
    th.start()
    data = caps.arrays[0].tobytes()
    base = f"http://127.0.0.1:{port}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=5) as r:
            return json.loads(r.read())

    state = plot = None
    with os.fdopen(wfd, "wb") as w:
        # the stream head (12 frames) and 2 rounds, then ask for a plot
        # before the rest arrives: nothing is built yet
        head = 2 * 12 * FS + 2 * 2 * 4 * FS
        w.write(data[:head])
        w.flush()
        deadline = time.time() + 60
        first = None
        while first is None and time.time() < deadline:
            try:
                urllib.request.urlopen(base + "/plot.json?stream=1",
                                       timeout=5)
                first = 200
            except urllib.error.HTTPError as e:
                first = e.code
                assert e.headers["Retry-After"] == "1"
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.1)
        assert first == 503
        w.write(data[head:])          # the pipe stays open: still "live"
        w.flush()
        while time.time() < deadline:
            try:
                if plot is None:
                    plot = get("/plot.json?stream=1")
                state = get("/state.json")
                if state.get("totals", {}).get("rounds", 0) >= 8:
                    break
            except urllib.error.HTTPError as e:
                assert e.code == 503
            except (urllib.error.URLError, ConnectionError):
                pass
            time.sleep(0.2)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=5) as r:
            page = r.read()
            assert b"fleet_serve live status" in page
            assert b"/plot.json?stream=" in page
    th.join(timeout=60)
    assert not th.is_alive() and result["rc"] == 0
    assert state["totals"]["rounds"] >= 8 and len(state["streams"]) == 2
    assert state["streams"][0]["ensemble"] == "C0FE"
    assert plot is not None and "error" not in plot
    assert plot["stream"] == 1 and plot["rounds"] >= 3
    for k in ("impulse_db", "freq_response_db", "spectrum_db"):
        assert len(plot[k]) >= 128 and np.isfinite(plot[k]).all(), k
    con = np.asarray(plot["constellation"], np.float64)
    assert con.shape[0] >= 256 and np.hypot(con[:, 0], con[:, 1]).mean() > 0.3
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[-1]["rounds"] == 10
    # a taken port loses the live view, not the serving
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        rc, lines, err = run_cli(
            tserve, ["-i", caps.paths[0], "--subchannels", LAYOUT, "--port",
                     str(s.getsockname()[1]), "--max-rounds", "2", *BASE],
            capsys, monkeypatch)
    assert rc == 0 and lines[-1]["rounds"] == 2 and "unavailable" in err


def test_profile_trace_writes_the_fleet_spans(caps, tmp_path, capsys,
                                              monkeypatch):
    """--profile-trace PATH: the stdout lines of a run without it; the
    fleet's spans in the Chrome trace, under this process's pid; the stage
    table on stderr; with --port, /state.json adds that table and the
    programs' counts; and the profiler is off again after the run."""
    from dab_radio_tpu_torch.utils.profiler import get_profiler
    argv = ["-i", caps.paths[0], "--subchannels", LAYOUT, *BASE]
    want = run_cli(tserve, argv, capsys, monkeypatch)[1]
    boxes = []

    class Server:                      # the status server, minus the socket
        def shutdown(self):
            pass

        def server_close(self):
            pass

    def start(port):
        boxes.append({"json": b"{}", "plot": None, "plot_wanted": 0.0,
                      "plot_built": 0.0, "plot_stream": 0})
        return Server(), boxes[-1]
    monkeypatch.setattr(tserve, "_start_status_server", start)
    path = tmp_path / "trace.json"
    assert not get_profiler().enabled
    rc, got, err = run_cli(tserve, argv + ["--profile-trace", str(path),
                                           "--port", "1"],
                           capsys, monkeypatch)
    assert rc == 0 and got == want and not get_profiler().enabled
    rounds = want[-1]["rounds"]
    events = json.loads(path.read_text())["traceEvents"]
    count = {}
    for e in events:
        if e["ph"] == "X":
            assert e["pid"] == os.getpid() and e["dur"] >= 0
            count[e["name"]] = count.get(e["name"], 0) + 1
    assert count["fleet/consume"] == count["fleet/fetch_wait"] == rounds
    assert count["fleet/fire"] == rounds
    assert count["fleet/push_frames"] == 4 * rounds       # a CIF a frame
    assert count["fleet/rs_decode"] == count["fleet/finish"] > 0
    assert count["radio/fig_parse"] > 0
    assert "fleet/consume" in err and "# profiler:" in err
    state = json.loads(boxes[0]["json"])
    assert state["profiler"]["fleet/consume"]["count"] == rounds
    assert state["graphs"] == {"captures": 0, "replays": 0,
                               "capture_s": 0.0}           # eager: the CPU
    assert set(state["mp2"]) == {"frames", "bytes", "synced"}
    assert state["totals"] == want[-1]


def test_backend_and_variant_flags(caps, capsys):
    argv = ["-i", caps.paths[0], "--subchannels", LAYOUT, "-M", "2"]
    if not torch.cuda.is_available():
        # the default backend is the card, and without one it raises
        with pytest.raises(RuntimeError, match="cuda"):
            tserve.main(argv)
        with pytest.raises(RuntimeError, match="cuda"):
            tserve.main(argv + ["--backend", "cuda"])
    with pytest.raises(SystemExit):                  # not a value of the flag
        tserve.main(argv + ["--backend", "cpu", "--viterbi", "radix2"])
    with pytest.raises(ValueError, match="--subchannels or --discover"):
        tserve.main(["-i", caps.paths[0], "--backend", "cpu"])
    with pytest.raises(SystemExit):
        tserve.main(["-i", caps.paths[0], "--shared-input", "--backend",
                     "cpu"])
    capsys.readouterr()


@pytest.mark.parametrize("flags", [
    ["--viterbi", "tiled"], ["--viterbi", "tiled", "--chainback", "parallel"],
    ["--chainback", "fused"]], ids=lambda f: "-".join(f[1::2]))
def test_decode_variant_flags_match_jax(caps, capsys, monkeypatch, flags):
    """--viterbi tiled and --chainback parallel|fused: the JAX CLI's lines,
    and at this SNR the default run's totals."""
    argv = ["-i", caps.paths[0], "--shared-input", "--streams", "2",
            "--subchannels", LAYOUT, "--max-rounds", "6", *BASE]
    lines, _ = both(argv + flags, capsys, monkeypatch)
    plain = run_cli(tserve, argv, capsys, monkeypatch)[1]
    assert lines == plain
    assert lines[-1]["rounds"] == 6 and lines[-1]["access_units"] > 0


def test_parse_subchannels_and_load_u8(tmp_path):
    spec = "0:48:EEP3A,48:84:UEP33:mp2,132:48:eep2b:packet@2+fec,180:6:EEP3A:packet@5"
    cfgs, kinds = tserve.parse_subchannels(spec)
    jcfgs, jkinds = jserve.parse_subchannels(spec)
    assert kinds == jkinds == ["audio", "mp2", ("packet", 2, 1),
                               ("packet", 5, 0)]
    assert [vars(c) for c in cfgs] == [vars(c) for c in jcfgs]
    for bad in ("0:48:XYZ", "0:48:EEP3A:video"):
        with pytest.raises(ValueError, match="--subchannels"):
            tserve.parse_subchannels(bad)
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, 4096).astype(np.uint8)
    (tmp_path / "a.u8").write_bytes(u8.tobytes())
    s16 = ((u8.astype(np.float32) - 127.5) / 127.5 * 32767).astype("<i2")
    (tmp_path / "a.s16").write_bytes(s16.tobytes())
    np.testing.assert_array_equal(
        tserve._load_u8(str(tmp_path / "a.u8"), "u8"), u8)
    np.testing.assert_array_equal(
        tserve._load_u8(str(tmp_path / "a.s16"), "s16le"),
        jserve._load_u8(str(tmp_path / "a.s16"), "s16le"))


@pytest.mark.parametrize("staged", [False, True])
def test_round_plot_matches_jax(caps, staged):
    """_maybe_build_plot on a round block of 2 streams (host numpy, or a
    tensor as the feeder stages it) and the same carry values: the payload
    of stream 1 equals the JAX server's within its rounding (0.02 for dB,
    0.002 for the constellation), and carries no "error"."""
    u8 = caps.arrays[0]
    chunk = 8 * FS
    blk = np.stack([u8[:chunk], u8[3 * FS:3 * FS + chunk]])
    fc, ff = np.float32([1e-4, 1300.0 / 2.048e6]), np.float32([0.0, 2e-5])

    def plot(mod, carry, rows):
        # the JAX fleet holds its carry as _carry, the port's hands out a
        # copy of the one its captured program holds as carry
        fleet = types.SimpleNamespace(N=2, _mode=2, device=torch.device("cpu"),
                                      _carry=carry, carry=carry,
                                      total_rounds=5)
        box = {"plot": None, "plot_wanted": 1.0, "plot_built": 0.0,
               "plot_stream": 7}
        mod._maybe_build_plot(fleet, box, rows)
        assert box["plot_built"] > 1.0
        return json.loads(box["plot"])

    want = plot(jserve, types.SimpleNamespace(freq_coarse=fc, freq_fine=ff),
                blk)
    got = plot(tserve, types.SimpleNamespace(freq_coarse=torch.from_numpy(fc),
                                             freq_fine=torch.from_numpy(ff)),
               torch.from_numpy(blk) if staged else blk)
    assert "error" not in got and set(got) == set(want)
    assert got["stream"] == want["stream"] == 1 and got["rounds"] == 5
    for k in ("impulse_db", "freq_response_db", "spectrum_db"):
        assert len(got[k]) == len(want[k]) >= 128
        assert np.abs(np.subtract(got[k], want[k])).max() <= 0.02 + 1e-9, k
    assert len(got["constellation"]) == len(want["constellation"]) >= 256
    assert np.abs(np.subtract(got["constellation"],
                              want["constellation"])).max() <= 0.002 + 1e-9
    assert abs(got["mer_db"] - want["mer_db"]) <= 0.1 + 1e-9


def test_sigint_stops_at_a_round_boundary(caps, tmp_path):
    """SIGINT to fleet_serve fed through `-i -` (a subprocess, its stdin a
    live pipe that keeps sending): it ends the round it is in, then ends as
    at the end of the stream: rc 0, the totals line last on stdout, and a
    --snapshot-out whose counters equal those totals."""
    import pickle
    import signal
    import subprocess
    from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port, snap = _free_port(), tmp_path / "live.snap"
    out, err = tmp_path / "out.txt", tmp_path / "err.txt"
    with open(out, "wb") as fo, open(err, "wb") as fe:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dab_radio_tpu_torch.apps.fleet_serve",
             "-i", "-", "--streams", "2", "--subchannels", LAYOUT, "--port",
             str(port), "--snapshot-out", str(snap), *BASE],
            cwd=root, stdin=subprocess.PIPE, stdout=fo, stderr=fe)
    data = caps.arrays[0].tobytes()

    def feed():                     # the capture again and again, live
        try:
            for _ in range(50):
                proc.stdin.write(data)
            proc.stdin.close()
        except (BrokenPipeError, OSError, ValueError):
            pass
    th = threading.Thread(target=feed, daemon=True)
    th.start()
    rounds, deadline = 0, time.time() + 120
    try:
        while rounds < 2 and time.time() < deadline \
                and proc.poll() is None:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/state.json",
                        timeout=5) as r:
                    rounds = json.loads(r.read()).get(
                        "totals", {}).get("rounds", 0)
            except (urllib.error.URLError, ConnectionError, OSError):
                pass
            time.sleep(0.1)
        assert rounds >= 2, "fleet_serve served no rounds"
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    th.join(timeout=10)
    text = err.read_text()
    assert rc == 0, text[-2000:]
    assert "# SIGINT: stopping after round" in text
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert len(lines) == 3 and [r["stream"] for r in lines[:2]] == [0, 1]
    total = lines[-1]
    assert "access_units" in total and total["streams"] == 2
    # stopped long before the 50 captures' end, between two rounds
    assert 2 <= total["rounds"] < 50 * 10
    assert total["frames"] == total["rounds"] * 4 * 2
    with open(snap, "rb") as f:
        blob = pickle.load(f)
    fleet = FusedFleet.from_snapshot(blob["fleet"], "cpu")
    assert (fleet.total_rounds, fleet.total_aus) \
        == (total["rounds"], total["access_units"])
    assert fleet.summary() == {k: v for k, v in total.items()
                               if k in fleet.summary()}
