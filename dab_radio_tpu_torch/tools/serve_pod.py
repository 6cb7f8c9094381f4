"""Pod-level serving orchestrator: one fleet_serve PROCESS per card
(independent streams want no traffic between cards and no shared failure
domain), plus one aggregated pod view. Port of ``tools/serve_pod.py``, same
flags and output.

Each worker is ``python -m dab_radio_tpu_torch.apps.fleet_serve`` with its
own card, its own snapshot file and a private status port. Under --backend
cuda worker k is pinned to card k mod the card count by
CUDA_VISIBLE_DEVICES in its environment (set before the process starts, so
before its first CUDA call); it then sees that card as cuda:0. The parent
polls every worker's /state.json and serves the merged view at /pod.json.
Workers that exit are reported, and on SIGINT every worker receives SIGINT,
so that each ends its round, prints its summary and writes its
--snapshot-out checkpoint.

Usage (a worker a card on a 4-card host; --backend cpu for a CPU demo):
  python -m dab_radio_tpu_torch.tools.serve_pod --workers 4 -i cap.u8 \\
      --shared-input --streams-per-worker 16 --subchannels 0:48:EEP3A \\
      --port 8900 --snapshot-dir snaps [--max-rounds N]
"""

import argparse
import collections
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

from ..utils.backend import add_backend_flag, apply_backend

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the last lines of each worker's output kept for the end (its summary is
# the last; the stream lines come just before it)
TAIL_LINES = 4096


def aggregate_pod(worker_states):
    """Merge parsed /state.json dicts (fleet_serve._status_blob shape:
    {"streams": [per-stream rows], "totals": {counters}}) into the pod
    counter view. Tolerates missing/None entries (worker not up yet)."""
    totals = [(s.get("totals") or {}) for s in worker_states
              if isinstance(s, dict)]
    return {
        "rounds": sum(t.get("rounds", 0) for t in totals),
        "access_units": sum(t.get("access_units", 0) for t in totals),
        "streams": sum(t.get("streams", 0) for t in totals),
    }


def _card_pins(nb_workers: int):
    """[(CUDA_VISIBLE_DEVICES value, card index, card name)] a worker:
    worker k takes card k mod the card count, counted among the cards this
    process sees (through its own CUDA_VISIBLE_DEVICES, when set)."""
    import torch
    count = torch.cuda.device_count()
    seen = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = [x.strip() for x in seen.split(",")][:count] if seen \
        else [str(i) for i in range(count)]
    return [(ids[k % count], k % count, torch.cuda.get_device_name(k % count))
            for k in range(nb_workers)]


def _drain(pipe, lines):
    """Read a worker's output as it comes, keeping the last lines: a worker
    whose output filled an unread pipe would block on its next write."""
    for ln in pipe:
        lines.append(ln.rstrip("\n"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("-i", "--input", required=True,
                    help="shared capture (every worker decodes its own "
                         "streams from it)")
    ap.add_argument("--shared-input", action="store_true", default=True)
    ap.add_argument("--streams-per-worker", type=int, default=2)
    ap.add_argument("--subchannels", default=None)
    ap.add_argument("--discover", action="store_true")
    ap.add_argument("--frames-per-step", type=int, default=8)
    ap.add_argument("--max-rounds", type=int, default=0)
    ap.add_argument("--port", type=int, default=0,
                    help="aggregated /pod.json on 127.0.0.1:PORT")
    ap.add_argument("--base-port", type=int, default=8950,
                    help="workers get base-port+k status ports")
    ap.add_argument("--snapshot-dir", default=None)
    add_backend_flag(ap)
    args = ap.parse_args(argv)
    device = apply_backend(args)
    pins = _card_pins(args.workers) if device.type == "cuda" else None
    if threading.current_thread() is threading.main_thread():
        # KeyboardInterrupt starts the fan-out below, also where this
        # process was started with SIGINT ignored
        signal.signal(signal.SIGINT, signal.default_int_handler)

    procs, outputs, readers = [], [], []
    for k in range(args.workers):
        # workers run from the repository root: paths go to them absolute
        cmd = [sys.executable, "-m", "dab_radio_tpu_torch.apps.fleet_serve",
               "-i", os.path.abspath(args.input), "--shared-input",
               "--streams", str(args.streams_per_worker),
               "--frames-per-step", str(args.frames_per_step),
               "--port", str(args.base_port + k),
               "--backend", args.backend]
        if args.subchannels:
            cmd += ["--subchannels", args.subchannels]
        else:
            cmd += ["--discover"]
        if args.max_rounds:
            cmd += ["--max-rounds", str(args.max_rounds)]
        if args.snapshot_dir:
            os.makedirs(args.snapshot_dir, exist_ok=True)
            cmd += ["--snapshot-out", os.path.abspath(
                os.path.join(args.snapshot_dir, f"worker{k}.snap"))]
        env = dict(os.environ)
        where = "device cpu"
        if pins is not None:
            env["CUDA_VISIBLE_DEVICES"] = pins[k][0]
            where = (f"card {pins[k][1]} ({pins[k][2]}, "
                     f"CUDA_VISIBLE_DEVICES={pins[k][0]})")
        p = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             start_new_session=True)
        procs.append(p)
        outputs.append(collections.deque(maxlen=TAIL_LINES))
        readers.append(threading.Thread(target=_drain,
                                        args=(p.stdout, outputs[-1]),
                                        daemon=True))
        readers[-1].start()
        print(f"# worker {k}: pid={p.pid} status port "
              f"{args.base_port + k} {where}", file=sys.stderr, flush=True)

    last_state = {}

    def pod_state():
        out = {"workers": []}
        for k, p in enumerate(procs):
            w = {"worker": k, "pid": p.pid,
                 "alive": p.poll() is None, "rc": p.poll()}
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{args.base_port + k}/state.json",
                        timeout=2) as r:
                    last_state[k] = json.loads(r.read())
            except Exception:
                pass                       # keep the last-seen state
            w["state"] = last_state.get(k)
            out["workers"].append(w)
        out["pod"] = dict(
            alive_workers=sum(w["alive"] for w in out["workers"]),
            **aggregate_pod([w["state"] for w in out["workers"]]))
        return out

    srv = None
    if args.port:
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)

        class H(BaseHTTPRequestHandler):
            def do_GET(self):
                body = json.dumps(pod_state()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        srv = ThreadingHTTPServer(("127.0.0.1", args.port), H)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        print(f"# pod view on http://127.0.0.1:{args.port}/pod.json",
              file=sys.stderr, flush=True)

    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            time.sleep(2)
            pod_state()                    # refresh the last-seen cache
        rc = max((p.returncode or 0) for p in procs)
    except KeyboardInterrupt:
        # graceful: workers end their round and write their snapshots
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGINT)
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
    finally:
        if srv:
            srv.shutdown()
        # authoritative totals come from each worker's final stdout
        # summary (the live /state.json is best-effort: under CPU-bound
        # demo load the workers' status threads can starve)
        totals = {"rounds": 0, "access_units": 0, "streams": 0}
        exited_ok = 0
        for k, p in enumerate(procs):
            readers[k].join(timeout=30)      # to the worker's end of output
            tail = [ln for ln in outputs[k] if ln.strip()]
            summ = None
            for ln in reversed(tail):
                if ln.startswith("{") and "access_units" in ln:
                    try:
                        summ = json.loads(ln)
                        break
                    except json.JSONDecodeError:
                        pass
            for ln in tail[-3:]:
                print(f"# worker {k}: {ln}", file=sys.stderr)
            if summ:
                exited_ok += 1
                for key in totals:
                    totals[key] += int(summ.get(key, 0))
    print(json.dumps({"metric": "pod_serving", "workers": len(procs),
                      "workers_reporting": exited_ok, **totals}),
          flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
