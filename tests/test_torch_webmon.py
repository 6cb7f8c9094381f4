"""The port's ``apps/webmon.py`` on the CPU (``--backend cpu``), as a
subprocess on a free port, on the capture of ``tests/test_torch_monitor.py``
(mode I, 2 DAB+ services with X-PAD, 12 frames). The checks are those the
JAX package's webmon tests make: the ensemble in ``/state.json``, the four
panels of ``/plot.json``, ``/device.json`` and a ``/tune`` retune with its
Origin gate, the PNG dashboard, ``/control``, and ``--max-frames`` on the
``-i`` pump. Every wait has a deadline; the process is ended in ``finally``.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from dab_radio_tpu_torch.apps import webmon
from test_torch_monitor import make_capture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 90


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    return make_capture(tmp_path_factory.mktemp("webmon") / "cap.u8")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Server:
    """webmon as a subprocess; GET/POST helpers against it."""

    def __init__(self, args):
        self.port = _free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "dab_radio_tpu_torch.apps.webmon",
             "--port", str(self.port), "--backend", "cpu", *args],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE)

    def get(self, path, timeout=30):
        with urllib.request.urlopen(self.base + path, timeout=timeout) as r:
            return r.read()

    def post(self, path, body, headers=None):
        req = urllib.request.Request(self.base + path, data=body,
                                     method="POST", headers=headers or {})
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    def wait_state(self, cond):
        """/state.json once cond(state) holds, before the deadline."""
        deadline = time.time() + DEADLINE_S
        state = None
        while time.time() < deadline:
            assert self.proc.poll() is None, self.proc.stderr.read()[-2000:]
            try:
                state = json.loads(self.get("/state.json", timeout=5))
                if cond(state):
                    return state
            except (urllib.error.URLError, ConnectionError):
                pass
            time.sleep(0.2)
        raise AssertionError(f"webmon: condition not met by the deadline: "
                             f"{state}")

    def close(self):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)
        self.proc.stderr.close()


def _ensemble(frames):
    return lambda s: s.get("ensemble", {}).get("id") == "C0FE" \
        and len(s.get("services", [])) == 2 and s.get("frames", 0) >= frames


def _http_error(fn):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn()
    return e.value.code


def test_webmon_serves_plots_and_retunes(capture):
    srv = _Server(["-i", str(capture), "-F", "u8", "--device", "file",
                   "--loop", "-c", "9C"])
    try:
        state = srv.wait_state(_ensemble(6))
        assert [s["label"].strip() for s in state["services"]] \
            == ["Radio TPU 1", "Radio TPU 2"]
        assert state["desync"] == 0 and "mer_db" in state
        assert "profiler" in state and state["channels"]

        plot = json.loads(srv.get("/plot.json"))
        assert "error" not in plot and plot["frames"] >= 6
        for k in ("impulse_db", "freq_response_db", "spectrum_db"):
            assert len(plot[k]) >= 128 and np.isfinite(plot[k]).all(), k
        con = np.asarray(plot["constellation"], np.float64)
        assert con.shape[0] >= 256 and con.shape[1] == 2
        assert np.isfinite(con).all()
        assert float(np.hypot(con[:, 0], con[:, 1]).mean()) > 0.3

        page = srv.get("/")
        assert b"live monitor" in page and b"p_con" in page \
            and b"plot.json" in page
        dev = json.loads(srv.get("/device.json"))
        assert dev["device"] == "FileDevice" and dev["channel"] == "9C"
        assert dev["freq_hz"] == 206352000 and dev["running"]

        png = srv.get("/dashboard.png", timeout=60)
        assert png[:8] == b"\x89PNG\r\n\x1a\n" and len(png) > 10_000

        # per-channel controls, with the same Origin gate as /tune
        sub = state["channels"][0]["subchannel"]
        assert _http_error(lambda: srv.post(
            "/control", json.dumps({"subchannel": sub, "flag": "play_audio",
                                    "value": True}).encode(),
            {"Origin": "http://evil.example"})) == 403
        ctl = srv.post("/control", json.dumps(
            {"subchannel": sub, "flag": "decode_data", "value": True})
            .encode())
        assert [c for c in ctl["channels"] if c["subchannel"] == sub][0][
            "controls"]["decode_data"] is True
        assert _http_error(lambda: srv.post("/control", b"5")) == 400
        assert _http_error(lambda: srv.get("/slideshow/999")) == 404
        assert _http_error(lambda: srv.get("/nowhere")) == 404

        assert _http_error(lambda: srv.post(
            "/tune", b'{"channel": "12B"}',
            {"Origin": "http://evil.example"})) == 403
        assert _http_error(lambda: srv.post(
            "/tune", b'{"channel": "99Z"}')) == 400
        tuned = srv.post("/tune", b'{"channel": "12B"}')
        assert tuned["channel"] == "12B" and tuned["freq_hz"] == 225648000
        # a retune restarts the decode from nothing: frames count again
        # from 0 and the ensemble is found again
        srv.wait_state(_ensemble(4))
    finally:
        srv.close()


def test_webmon_pump_honors_max_frames(capture):
    srv = _Server(["-i", str(capture), "-F", "u8", "--max-frames", "6"])
    try:
        state = srv.wait_state(lambda s: s.get("done"))
        assert state["frames"] == 6
        assert state["ensemble"]["id"] == "C0FE"
        dev = json.loads(srv.get("/device.json"))
        assert dev["device"] is None and not dev["running"]
        # no tuner behind the -i pump: /tune has nothing to retune
        assert _http_error(lambda: srv.post(
            "/tune", b'{"channel": "12B"}')) == 404
    finally:
        srv.close()


def test_webmon_device_rejects_wav_format(capsys):
    with pytest.raises(SystemExit) as e:
        webmon.main(["--device", "file", "-i", "x.wav", "-F", "wav",
                     "--port", "0", "--backend", "cpu"])
    assert e.value.code == 2
    assert "does not support -F wav" in capsys.readouterr().err


def test_empty_state_answers_503():
    """Before the first frame /plot.json and /dashboard.png have nothing to
    draw; /state.json still answers."""
    st = webmon._State()
    assert webmon._plot_json(st) == b"" and webmon._dashboard_png(st) == b""
    out = json.loads(webmon._state_json(st))
    assert out["frames"] == 0 and not out["done"] and "ensemble" not in out
