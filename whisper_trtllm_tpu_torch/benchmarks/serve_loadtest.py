"""Serving-daemon load harness (counterpart of the repository's
``scripts/serve_loadtest.py``).

Starts ``python -m whisper_trtllm_tpu_torch.cli.serve`` as a subprocess
(any backend) on a port the OS picks unless ``--port`` names one, drives
N concurrent closed-loop clients POSTing the WAV files of a directory in
turn, and prints one JSON line: latency percentiles (ms), requests/s,
audio-s/s (of 30 s windows, as the JAX harness counts, and of speech),
the time each request took to open its connection (the daemon answers
HTTP/1.0 and closes it, so every request connects; part of its latency),
and the healthz answer (the sched backend's queue stats among it).

  python -m whisper_trtllm_tpu_torch.benchmarks.serve_loadtest \\
      --checkpoint DIR --wav-dir DIR [--backend slots|ifb|sched] \\
      [--clients 16] [--requests 64] [--port 0] [--max-new-tokens 32] \\
      [--num-slots 8] [--dtype ...] [--kv-cache-dtype ...] [--cpu] \\
      [--daemon-log FILE]

One warm-up request runs before the clients start (on the card it
captures the decode step of the slots backend's batch).
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import pathlib
import re
import subprocess
import sys
import threading
import time
import wave

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Daemon:
    """``cmd`` (a ``cli.serve`` command) as a subprocess: a thread copies
    its output to the file ``log`` (None: dropped) and takes the port from
    its ``serving on :N`` line; ``stop()`` ends it."""

    def __init__(self, cmd: list, log=None, env=None):
        self.port = None
        self._log = open(log, "w") if log else None
        self.proc = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            m = self.port is None and re.match(r"serving on :(\d+) ", line)
            if m:
                self.port = int(m.group(1))
            if self._log:
                self._log.write(line)
                self._log.flush()

    def wait_healthy(self, deadline_s: float) -> None:
        """Until a 200 from ``/healthz`` that names this daemon's process:
        another process that answers on the port does not count."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < deadline_s:
            if self.proc.poll() is not None:
                raise RuntimeError(f"daemon exited with "
                                   f"{self.proc.returncode}")
            if self.port is not None:
                try:
                    c = http.client.HTTPConnection("localhost", self.port,
                                                   timeout=2)
                    c.request("GET", "/healthz")
                    r = c.getresponse()
                    if (r.status == 200
                            and json.loads(r.read()).get("pid")
                            == self.proc.pid):
                        return
                except (OSError, http.client.HTTPException, ValueError):
                    pass
            time.sleep(0.5)
        raise RuntimeError(f"daemon not healthy after {deadline_s}s")

    def stop(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self._reader.join(timeout=10)
        if self._log:
            self._log.close()


def _speech_s(blob: bytes) -> float:
    import io

    with wave.open(io.BytesIO(blob), "rb") as f:
        return f.getnframes() / f.getframerate()


def daemon_command(args) -> list:
    cmd = [sys.executable, "-m", "whisper_trtllm_tpu_torch.cli.serve",
           "--checkpoint", args.checkpoint, "--port", str(args.port),
           "--num-slots", str(args.num_slots), "--backend", args.backend,
           "--max-new-tokens", str(args.max_new_tokens)]
    if args.cpu:
        cmd.append("--cpu")
    if args.dtype:
        cmd += ["--dtype", args.dtype]
    if args.kv_cache_dtype:
        cmd += ["--kv-cache-dtype", args.kv_cache_dtype]
    return cmd


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--wav-dir", required=True)
    ap.add_argument("--backend", default="slots",
                    choices=["slots", "ifb", "sched"])
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--port", type=int, default=0,
                    help="the daemon's port (0: one the OS picks)")
    ap.add_argument("--num-slots", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--startup-timeout", type=float, default=600.0)
    ap.add_argument("--cpu", action="store_true",
                    help="run the daemon on the CPU (smoke tests)")
    ap.add_argument("--dtype", default=None,
                    choices=[None, "float32", "bfloat16"])
    ap.add_argument("--kv-cache-dtype", default=None,
                    choices=[None, "auto", "int8", "fp8"],
                    help="KV storage precision passed through to the daemon")
    ap.add_argument("--daemon-log", default=None,
                    help="file for the daemon's output (default: dropped)")
    args = ap.parse_args(argv)

    wavs = sorted(pathlib.Path(args.wav_dir).glob("*.wav"))
    if not wavs:
        raise FileNotFoundError(f"no wavs under {args.wav_dir}")
    blobs = [w.read_bytes() for w in wavs]
    speech = [_speech_s(b) for b in blobs]

    daemon = Daemon(daemon_command(args), args.daemon_log)
    try:
        daemon.wait_healthy(args.startup_timeout)
        port = daemon.port

        # warm-up: one request end to end (the slots backend captures the
        # step of its batch here)
        c = http.client.HTTPConnection("localhost", port, timeout=1200)
        c.request("POST", "/transcribe", body=blobs[0])
        r = c.getresponse()
        r.read()
        if r.status != 200:
            raise RuntimeError(f"warm-up request answered {r.status}")

        lats: list = []
        done: list = []
        errors: list = []
        connects: list = []
        lock = threading.Lock()
        counter = {"next": 0}

        def client():
            conn = http.client.HTTPConnection("localhost", port, timeout=600)
            while True:
                with lock:
                    i = counter["next"]
                    if i >= args.requests:
                        return
                    counter["next"] = i + 1
                t0 = time.perf_counter()
                try:
                    if conn.sock is None:
                        conn.connect()
                        with lock:
                            connects.append(time.perf_counter() - t0)
                    conn.request("POST", "/transcribe",
                                 body=blobs[i % len(blobs)])
                    r = conn.getresponse()
                    r.read()
                    dt = time.perf_counter() - t0
                    with lock:
                        if r.status == 200:
                            lats.append(dt)
                            done.append(i % len(blobs))
                        else:
                            errors.append(r.status)
                except OSError as e:
                    conn = http.client.HTTPConnection(
                        "localhost", port, timeout=600)
                    with lock:
                        errors.append(repr(e))

        t_start = time.perf_counter()
        threads = [threading.Thread(target=client)
                   for _ in range(args.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t_start

        def pct(q):
            return float(np.percentile(lats, q)) * 1e3

        report = {
            "backend": args.backend,
            "clients": args.clients,
            "requests": args.requests,
            "requests_ok": len(lats),
            "errors": errors[:5],
            "wall_s": wall,
            "throughput_req_s": len(lats) / wall,
            "audio_s_per_s": len(lats) * 30.0 / wall,
            "speech_s_per_s": sum(speech[i] for i in done) / wall,
            "latency_ms": {"p50": pct(50), "p90": pct(90), "p95": pct(95),
                           "p99": pct(99), "max": max(lats) * 1e3}
            if lats else None,
            "num_slots": args.num_slots,
            "max_new_tokens": args.max_new_tokens,
            "connect_ms": {"n": len(connects),
                           "p50": float(np.percentile(connects, 50)) * 1e3,
                           "max": max(connects) * 1e3,
                           "over_1s": sum(c >= 1.0 for c in connects)}
            if connects else None,
        }
        try:
            c = http.client.HTTPConnection("localhost", port, timeout=10)
            c.request("GET", "/healthz")
            report["healthz"] = json.loads(c.getresponse().read())
        except OSError:
            pass
        print(json.dumps(report), flush=True)
        return report
    finally:
        daemon.stop()


if __name__ == "__main__":
    main()
