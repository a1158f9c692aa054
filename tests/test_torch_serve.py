"""PyTorch port: serving on the CPU — the native binding against the JAX
package's binding of the same ``cpp/`` library, the three servers'
submit/step/fetch, the HTTP daemon (``cli.serve``) in process and as a
``--cpu`` subprocess, and the load harness's smoke run.

The model is a toy checkpoint with the real frontend geometry (80 mels,
3000 frames, 1500 encoder positions), as ``tests/test_serve_loadtest.py``
builds it; every served request's tokens must equal the port's lockstep
``transcribe_tokens`` on the same audio, exactly.
"""

import http.client
import io
import json
import struct
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from whisper_trtllm_tpu.native import lib as jax_native
from whisper_trtllm_tpu_torch import native
from whisper_trtllm_tpu_torch.audio.features import (
    LogMelSpectrogram,
    pad_or_trim,
)
from whisper_trtllm_tpu_torch.cli import serve
from whisper_trtllm_tpu_torch.config import GenerationConfig, WhisperConfig
from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
from whisper_trtllm_tpu_torch.runtime import generation
from whisper_trtllm_tpu_torch.runtime.server import (
    IfbTranscriptionServer,
    ScheduledTranscriptionServer,
    TranscriptionServer,
)
from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
from whisper_trtllm_tpu_torch.utils.checkpoint import save_checkpoint

ROOT = __file__.rsplit("/tests/", 1)[0]
NEW = 8
SECONDS = (0.6, 1.0, 0.4, 0.8)   # the requests' lengths


def wav_bytes(samples: np.ndarray, rate=16000) -> bytes:
    pcm = (np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes()
    buf = io.BytesIO()
    buf.write(b"RIFF")
    buf.write(struct.pack("<I", 36 + len(pcm)))
    buf.write(b"WAVEfmt ")
    buf.write(struct.pack("<IHHIIHH", 16, 1, 1, rate, rate * 2, 2, 16))
    buf.write(b"data")
    buf.write(struct.pack("<I", len(pcm)))
    buf.write(pcm)
    return buf.getvalue()


class _Toy:
    """A toy checkpoint with the real frontend geometry, four WAVs, and
    each one's lockstep tokens (the port's transcribe_tokens on the CPU)."""

    def __init__(self, tmp):
        self.cfg = WhisperConfig.testing(
            vocab_size=51864, num_mel_bins=80, d_model=64,
            encoder_ffn_dim=128, decoder_ffn_dim=128,
            max_source_positions=1500, max_target_positions=64,
            decoder_start_token_id=50257, eos_token_id=50256,
            pad_token_id=50256, bos_token_id=50257,
            suppress_tokens=(), begin_suppress_tokens=(220, 50256),
            forced_decoder_ids=((1, 50362),))
        self.params = wmodel.init_params(self.cfg, seed=0, device="cpu")
        self.ckpt = tmp / "ckpt"
        save_checkpoint(str(self.ckpt), self.params, self.cfg)
        self.wav_dir = tmp / "wavs"
        self.wav_dir.mkdir()
        rng = np.random.default_rng(0)
        self.blobs = []
        for i, sec in enumerate(SECONDS):
            blob = wav_bytes(rng.standard_normal(int(16000 * sec))
                             .astype(np.float32) * 0.1 * (i + 1))
            (self.wav_dir / f"u{i}.wav").write_bytes(blob)
            self.blobs.append(blob)
        self.audio = [native.load_wav_16k(b) for b in self.blobs]
        self.gen = GenerationConfig(max_new_tokens=NEW)
        mel = LogMelSpectrogram(80, device="cpu")(
            np.stack([pad_or_trim(a) for a in self.audio]))
        toks, lens = generation.transcribe_tokens(self.params, self.cfg, mel,
                                                  self.gen, device="cpu")
        self.want = [toks[i, :lens[i]].tolist() for i in range(len(SECONDS))]

    def session(self):
        return WhisperSession(self.params, self.cfg, self.gen,
                              device="cpu")


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return _Toy(tmp_path_factory.mktemp("serve"))


# --------------------------------------------------------------------------
# the native binding, against the JAX package's
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_lib():
    """The JAX package's binding, loading the library the port built from
    the same sources (its own cmake build is left to its own tests)."""
    saved = (jax_native._SO_PATH, jax_native._lib)
    jax_native._SO_PATH, jax_native._lib = native.build_native(), None
    jax_native.load_library(auto_build=False)
    yield jax_native
    jax_native._SO_PATH, jax_native._lib = saved


@pytest.mark.parametrize("rate,seconds", [(16000, 1.0), (8000, 0.5),
                                          (44100, 0.25)])
def test_wav_decoding_equals_the_jax_binding(jax_lib, rate, seconds):
    x = np.random.default_rng(rate).standard_normal(
        int(rate * seconds)).astype(np.float32) * 0.2
    blob = wav_bytes(x, rate)
    got = native.load_wav_16k(blob)
    np.testing.assert_array_equal(got, jax_lib.load_wav_16k(blob))
    assert got.dtype == np.float32 and got.shape == (int(16000 * seconds),)
    for lib in (native, jax_lib):
        with pytest.raises(ValueError, match="malformed"):
            lib.load_wav_16k(b"not a wav file at all........")


def test_slot_manager_flow_equals_the_jax_binding(jax_lib):
    def flow(lib):
        sm = lib.NativeSlotManager(num_slots=2, max_samples=64)
        ids = [sm.submit(np.full(n, v, np.float32))
               for n, v in ((10, 1.0), (20, 2.0), (30, 3.0))]
        out = [ids, sm.pending]
        sched = sm.schedule()
        out += [sched[0].tolist(), sched[1].tolist(), sched[2]]
        sm.complete(0, np.asarray([5, 6, 7], np.int32))
        out += [sm.fetch(ids[0]).tolist(), sm.fetch(ids[1])]
        sched = sm.schedule()
        out += [sched[0].tolist(), sched[2], sm.pending]
        return out

    got = flow(native)
    assert got == flow(jax_lib)
    assert got[2] == got[0][:2] and got[5] == [5, 6, 7]


def test_batch_scheduler_flow_equals_the_jax_binding(jax_lib):
    """Full batches, priorities and flush: the parts of the policy that no
    clock decides."""
    def flow(mod):
        s = mod.NativeBatchScheduler([2, 4], max_wait_ms=60_000)
        out = [s.poll()[0].tolist()]
        for i in (1, 2, 3, 4):
            s.submit(i)
        out.append(s.poll()[0].tolist())
        s.submit(10)
        s.submit(11, priority=9)
        s.submit(12)
        s.submit(13)
        s.submit(14, priority=3)
        out.append(s.poll()[0].tolist())
        out.append([b.tolist() for b in s.flush()])
        st = s.stats()
        out.append({k: st[k] for k in ("submitted", "launched_batches",
                                        "launched_requests", "expired")})
        return out

    got = flow(native)
    assert got == flow(jax_lib)
    assert got[1] == [1, 2, 3, 4] and got[2][0] == 11


def test_native_library_builds_with_gpp_into_build(tmp_path, monkeypatch):
    """A fresh build directory: ``build_native`` runs g++ alone (no cmake)
    and names the library by a digest of the sources."""
    monkeypatch.setattr(native.lib, "BUILD_DIR", tmp_path)
    path = native.lib.build_native()
    assert path.startswith(str(tmp_path)) and path.endswith(".so")
    assert native.lib.library_path().name in path
    assert native.lib.build_native() == path   # up to date: no rebuild


# --------------------------------------------------------------------------
# the three servers
# --------------------------------------------------------------------------

def _drain(srv, rids, rounds=200):
    got = {}
    for _ in range(rounds):
        for r in rids:
            if r not in got:
                out = srv.fetch(r)
                if out is not None:
                    got[r] = out
        if len(got) == len(rids):
            return [np.asarray(got[r]).tolist() for r in rids]
        srv.step()
    raise AssertionError(f"{len(got)} of {len(rids)} requests done")


def test_slots_server_serves_the_lockstep_tokens(toy):
    srv = TranscriptionServer(toy.session(), num_slots=2, max_samples=480000)
    rids = [srv.submit(a) for a in toy.audio]
    assert srv.pending == 4
    assert _drain(srv, rids) == toy.want
    assert srv.pending == 0


def test_ifb_server_serves_the_lockstep_tokens(toy):
    srv = IfbTranscriptionServer(toy.params, toy.cfg, toy.gen, num_slots=2,
                                 segment_steps=4, device="cpu")
    rids = [srv.submit(a) for a in toy.audio]   # compute_mel, then submit
    assert srv.pending == 4
    assert _drain(srv, rids) == toy.want


def test_sched_server_serves_and_expires(toy):
    srv = ScheduledTranscriptionServer(toy.session(),
                                       allowed_batch_sizes=(1, 2),
                                       max_wait_ms=5)
    rids = [srv.submit(a) for a in toy.audio[:3]]
    srv.run_until_drained()
    assert [np.asarray(srv.fetch(r)).tolist() for r in rids] == toy.want[:3]
    late = srv.submit(toy.audio[3], timeout_ms=1)
    time.sleep(0.01)
    srv.step()
    out = srv.fetch(late)
    assert out is srv.EXPIRED or np.asarray(out).tolist() == toy.want[3]
    st = srv.stats()
    assert st["submitted"] == 4 and st["launched_requests"] >= 3


def test_cache_dir_is_refused_as_the_session_refuses_it(toy):
    args = serve.parse_args(["--checkpoint", str(toy.ckpt), "--cpu",
                             "--cache-dir", "somewhere"])
    with pytest.raises(NotImplementedError, match="persistent_cache_dir"):
        serve.build_server(args)


# --------------------------------------------------------------------------
# the HTTP daemon
# --------------------------------------------------------------------------

def _post(port, body, path="/transcribe"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, body=body)
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def _get(port, path="/healthz"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def _concurrent(port, blobs):
    out = [None] * len(blobs)

    def worker(i):
        out[i] = _post(port, blobs[i])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(blobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return out


@pytest.mark.parametrize("backend", ["slots", "sched"])
def test_daemon_in_process(toy, backend):
    args = serve.parse_args(["--checkpoint", str(toy.ckpt), "--cpu",
                             "--backend", backend, "--num-slots", "2",
                             "--max-new-tokens", str(NEW), "--dtype",
                             "float32", "--max-wait-ms", "5"])
    server, cfg = serve.build_server(args)
    state = {"server": server, "specials": {cfg.eos_token_id}}
    stop = threading.Event()
    threading.Thread(target=serve.scheduler_loop, args=(state, stop),
                     daemon=True).start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.build_handler(state))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    try:
        status, health = _get(port)
        assert status == 200 and health["status"] == "ok"
        assert ("scheduler" in health) == (backend == "sched")
        replies = _concurrent(port, toy.blobs)
        assert [s for s, _ in replies] == [200] * 4
        assert [r["tokens"] for _, r in replies] == toy.want
        assert len({r["request_id"] for _, r in replies}) == 4
        assert _post(port, b"garbage bytes")[0] == 400
        assert _get(port, "/nope")[0] == 404
    finally:
        stop.set()
        httpd.shutdown()
        httpd.server_close()


def test_scheduler_failure_is_reported():
    class Broken:
        pending = 0

        def step(self):
            raise RuntimeError("card lost")

    state = {"server": Broken()}
    serve.scheduler_loop(state, threading.Event())
    assert state["error"] == "RuntimeError: card lost"


def test_ifb_daemon_subprocess_on_the_cpu(toy):
    """``python -m whisper_trtllm_tpu_torch.cli.serve --cpu``, ifb backend,
    on a port the OS picks: healthz (naming the daemon's process), a round
    trip, four requests at once, a bad WAV."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "whisper_trtllm_tpu_torch.cli.serve",
         "--checkpoint", str(toy.ckpt), "--cpu", "--backend", "ifb",
         "--num-slots", "2", "--max-new-tokens", str(NEW), "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on :")
        port = int(line.split(":")[1].split()[0])
        assert port > 0
        status, health = _get(port)
        assert status == 200 and health == {"status": "ok", "pending": 0,
                                            "pid": proc.pid}
        status, one = _post(port, toy.blobs[1])
        assert status == 200 and one["tokens"] == toy.want[1]
        replies = _concurrent(port, toy.blobs)
        assert [r["tokens"] for _, r in replies] == toy.want
        status, bad = _post(port, b"RIFF....")
        assert status == 400 and "bad wav" in bad["error"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_load_harness_smoke(toy, capsys):
    from whisper_trtllm_tpu_torch.benchmarks.serve_loadtest import main

    report = main(["--checkpoint", str(toy.ckpt), "--wav-dir",
                   str(toy.wav_dir), "--backend", "slots", "--clients", "2",
                   "--requests", "4", "--num-slots", "2",
                   "--max-new-tokens", str(NEW),
                   "--cpu", "--dtype", "float32", "--startup-timeout",
                   "120"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(report))
    assert report["requests_ok"] == 4 and not report["errors"]
    # the daemon closes each connection: every request opens its own
    assert report["connect_ms"]["n"] == 4
    assert 0 < report["connect_ms"]["p50"] <= report["connect_ms"]["max"]
    lat = report["latency_ms"]
    assert 0 < lat["p50"] <= lat["p90"] <= lat["p95"] <= lat["p99"] \
        <= lat["max"]
    assert report["throughput_req_s"] > 0
    assert report["audio_s_per_s"] == pytest.approx(
        4 * 30.0 / report["wall_s"])
    # the four requests are u0..u3 once each
    assert report["speech_s_per_s"] == pytest.approx(
        sum(SECONDS) / report["wall_s"])
    assert report["healthz"]["status"] == "ok"


def test_the_harness_waits_for_its_own_daemon_only():
    """Another process that answers ``/healthz`` on the port the daemon
    names is not taken for the daemon: the harness waits on, and fails at
    its deadline."""
    from whisper_trtllm_tpu_torch.benchmarks.serve_loadtest import Daemon

    class Other(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            body = json.dumps({"status": "ok", "pending": 0,
                               "pid": -1}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    other = ThreadingHTTPServer(("127.0.0.1", 0), Other)
    threading.Thread(target=other.serve_forever, daemon=True).start()
    d = Daemon([sys.executable, "-c",
                f"import time; print('serving on :{other.server_address[1]} "
                f"(fake)', flush=True); time.sleep(60)"])
    try:
        with pytest.raises(RuntimeError, match="not healthy"):
            d.wait_healthy(2.0)
        assert d.port == other.server_address[1]
    finally:
        d.stop()
        other.shutdown()
        other.server_close()


def test_compute_mel_is_the_sessions_frontend(toy):
    srv = IfbTranscriptionServer(toy.params, toy.cfg, toy.gen, num_slots=2,
                                 device="cpu")
    mel = srv.batcher.compute_mel(toy.audio[0])
    want = LogMelSpectrogram(80, device="cpu")(pad_or_trim(toy.audio[0])[None])
    assert mel.shape == (1, 3000, 80) and torch.equal(mel, want)
