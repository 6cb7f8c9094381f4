"""The port's serving deployment, ``dab_radio_tpu_torch.tools.serve_pod``
(one fleet_serve process a card and the aggregated /pod.json view), on the
CPU: its ``aggregate_pod`` against ``tools/serve_pod.py``'s, a 2-worker pod
to the end of --max-rounds, and a 2-worker pod stopped by SIGINT while both
workers serve.

The capture is the port's own: ``simulate_transmitter --payload ensemble
--services 2`` on the CPU, 40 mode-I frames (and the same 4 times over for
the pod that SIGINT stops, so that no worker reaches the end first).
"""

import json
import os
import pickle
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
from dab_radio_tpu_torch.tools import serve_pod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUT = "0:48:EEP3A,48:48:EEP3A"
FRAMES = 40
POD = ["--workers", "2", "--streams-per-worker", "1", "--subchannels",
       LAYOUT, "--frames-per-step", "2", "--backend", "cpu"]


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    r = subprocess.run(
        [sys.executable, "-m", "dab_radio_tpu_torch.apps.simulate_transmitter",
         "--payload", "ensemble", "--services", "2", "-n", str(FRAMES), "-F",
         "u8", "--backend", "cpu"], capture_output=True, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-800:]
    root = tmp_path_factory.mktemp("serve_pod")
    (root / "cap.u8").write_bytes(r.stdout)
    (root / "long.u8").write_bytes(r.stdout * 4)
    return root


def _free_ports(n):
    """A port p with p, ..., p + n - 1 all free on 127.0.0.1."""
    for _ in range(100):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n > 65535:
            continue
        try:
            socks = []
            for k in range(n):
                socks.append(socket.socket())
                socks[-1].bind(("127.0.0.1", base + k))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no run of free ports")


def _pod(argv, **kw):
    return subprocess.Popen(
        [sys.executable, "-m", "dab_radio_tpu_torch.tools.serve_pod", *argv],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        **kw)


def _worker_totals(err):
    """Each worker's totals line, from the pod's `# worker k: ...` lines."""
    got = {}
    for m in re.finditer(r"^# worker (\d+): (\{.*\})$", err, re.M):
        row = json.loads(m.group(2))
        if "access_units" in row:
            got[int(m.group(1))] = row
    return [got[k] for k in sorted(got)]


def test_aggregate_pod_matches_the_jax_tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        from serve_pod import aggregate_pod as jax_aggregate
    finally:
        sys.path.pop(0)
    w = {"streams": [{"stream": 0}, {"stream": 1}],
         "totals": {"streams": 2, "rounds": 3, "frames": 24,
                    "access_units": 72, "services": 4}}
    for states in ([w, w, None], [], [None], [w, {"streams": []}, "down"]):
        assert serve_pod.aggregate_pod(states) == jax_aggregate(states)
    assert serve_pod.aggregate_pod([w, w, None]) == {
        "rounds": 6, "access_units": 144, "streams": 4}


def test_two_workers_to_max_rounds(capture, tmp_path):
    base = _free_ports(2)
    proc = _pod(["-i", str(capture / "cap.u8"), *POD, "--max-rounds", "2",
                 "--base-port", str(base), "--snapshot-dir",
                 str(tmp_path)])
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-2000:]
    assert "# worker 0: pid=" in err and "device cpu" in err
    pod = json.loads(out.strip().splitlines()[-1])
    assert pod["metric"] == "pod_serving" and pod["workers"] == 2
    assert pod["workers_reporting"] == 2
    workers = _worker_totals(err)
    assert len(workers) == 2 and all(w["rounds"] == 2 for w in workers)
    for key in ("rounds", "access_units", "streams"):
        assert pod[key] == sum(w[key] for w in workers)
    assert pod["streams"] == 2


def test_sigint_stops_every_worker_with_its_snapshot(capture, tmp_path):
    """SIGINT to the pod once /pod.json shows a round of each worker: each
    worker ends its round, prints its summary and writes its snapshot; the
    pod reports both and returns 0."""
    base, port = _free_ports(2), _free_ports(1)
    proc = _pod(["-i", str(capture / "long.u8"), *POD, "--base-port",
                 str(base), "--port", str(port), "--snapshot-dir",
                 str(tmp_path)])
    seen, deadline = None, time.time() + 180
    try:
        while time.time() < deadline and proc.poll() is None:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/pod.json", timeout=10) as r:
                    view = json.loads(r.read())
                rounds = [((w["state"] or {}).get("totals") or {})
                          .get("rounds", 0) for w in view["workers"]]
                if len(rounds) == 2 and min(rounds) >= 1:
                    seen = view
                    break
            except (urllib.error.URLError, ConnectionError, OSError):
                pass
            time.sleep(0.2)
        assert seen is not None, "the pod view never showed both workers"
        assert all(w["alive"] for w in seen["workers"])
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:      # the pod passes SIGINT to its workers
            proc.send_signal(signal.SIGINT)
            try:
                proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    pod = json.loads(out.strip().splitlines()[-1])
    assert pod["workers_reporting"] == 2
    workers = _worker_totals(err)
    assert len(workers) == 2
    for k, w in enumerate(workers):
        # stopped by SIGINT, not by the end of the capture
        assert 1 <= w["rounds"] < 4 * FRAMES // 2
        with open(tmp_path / f"worker{k}.snap", "rb") as f:
            fleet = FusedFleet.from_snapshot(pickle.load(f)["fleet"], "cpu")
        assert (fleet.total_rounds, fleet.total_aus, fleet.N) \
            == (w["rounds"], w["access_units"], w["streams"])
    for key in ("rounds", "access_units", "streams"):
        assert pod[key] == sum(w[key] for w in workers)
