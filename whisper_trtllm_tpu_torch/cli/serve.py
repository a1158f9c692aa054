"""HTTP serving daemon: POST a WAV, get token ids (and text) back
(counterpart of the repository's ``cli/serve.py``).

Requests land in the backend's queue (the native slot manager or batch
scheduler of ``cpp/``, or the in-flight batcher); a background scheduler
thread drains them on the CUDA card (``--cpu``: the plain PyTorch path on
the CPU), and each handler waits for its own result.

Usage:
  python -m whisper_trtllm_tpu_torch.cli.serve --checkpoint DIR [--port 8080]
      [--backend slots|ifb|sched] [--num-slots 8] [--max-new-tokens 224]
      [--dtype bfloat16] [--kv-cache-dtype auto|int8|fp8]
      [--max-wait-ms 20] [--hf-model LOCAL_DIR] [--cpu]

  curl -s -X POST --data-binary @utt.wav localhost:8080/transcribe
  → {"request_id": N, "tokens": [...], "text": "..."}   (text with --hf-model)
  curl -s localhost:8080/healthz
  → {"status": "ok", "pending": N, "pid": P}

``--port 0`` binds a port the OS picks; the ``serving on :N`` line names
it, and ``/healthz`` names the daemon's process, so that a caller can tell
its own daemon from another process on the port.

As in the JAX package's daemon, the ifb backend decodes with the weights
as loaded: ``--dtype`` reaches the slots and sched backends' session only.
``--cache-dir`` is the session's ``persistent_cache_dir``: the directory
where the kernels' libraries are built and found
(``utils.checkpoint.init_compilation_cache``), so a daemon started after
``cli.warm_cache`` with the same directory runs no ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

# a handler gives up on its request after this long
REQUEST_TIMEOUT_S = 120


def build_handler(server_state):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _reply(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                srv = server_state["server"]
                error = server_state.get("error")
                obj = {"status": "error" if error else "ok",
                       "pending": int(srv.pending), "pid": os.getpid()}
                if error:
                    obj["error"] = error
                stats = getattr(srv, "stats", None)
                if callable(stats):  # sched backend: native queue counters
                    obj["scheduler"] = stats()
                self._reply(500 if error else 200, obj)
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/transcribe":
                self._reply(404, {"error": "not found"})
                return
            length = int(self.headers.get("Content-Length", 0))
            blob = self.rfile.read(length)
            try:
                from whisper_trtllm_tpu_torch.native import load_wav_16k

                audio = load_wav_16k(blob)
            except Exception as e:  # noqa: BLE001 — any decode failure
                self._reply(400, {"error": f"bad wav: {e}"})
                return
            srv = server_state["server"]
            rid = srv.submit(audio)
            # synchronous completion: poll the results the scheduler
            # thread fills
            deadline = time.monotonic() + REQUEST_TIMEOUT_S
            tokens = None
            while time.monotonic() < deadline:
                if server_state.get("error"):
                    self._reply(500, {"error": server_state["error"],
                                      "request_id": int(rid)})
                    return
                tokens = srv.fetch(rid)
                if tokens is not None:
                    break
                time.sleep(0.02)
            if tokens is None:
                self._reply(504, {"error": "timeout"})
                return
            if isinstance(tokens, str):
                # ScheduledTranscriptionServer.EXPIRED: the request's
                # deadline passed before a batch launched
                self._reply(504, {"error": tokens, "request_id": int(rid)})
                return
            resp = {"request_id": int(rid), "tokens": [int(t) for t in tokens]}
            tok = server_state.get("tokenizer")
            if tok is not None:
                ids = [int(t) for t in tokens[1:]
                       if t not in server_state["specials"]]
                resp["text"] = tok.decode(ids, skip_special_tokens=True)
            self._reply(200, resp)

    return Handler


def scheduler_loop(server_state, stop: threading.Event):
    """Drain the request queue; handlers poll fetch(). A failing step
    stops the loop and is reported on every pending and later request."""
    srv = server_state["server"]
    while not stop.is_set():
        try:
            served = srv.step()
        except Exception as e:  # noqa: BLE001 — reported, not swallowed
            traceback.print_exc()
            server_state["error"] = f"{type(e).__name__}: {e}"
            return
        stop.wait(0.002 if served else 0.02)


def build_server(args):
    """(server, cfg) for the parsed arguments: the checkpoint loaded on the
    card (the CPU with ``--cpu``) and the chosen backend built on it."""
    import torch

    from whisper_trtllm_tpu_torch.config import GenerationConfig, RuntimeConfig
    from whisper_trtllm_tpu_torch.runtime.server import (
        IfbTranscriptionServer,
        ScheduledTranscriptionServer,
        TranscriptionServer,
    )
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
    from whisper_trtllm_tpu_torch.utils.device import resolve_device

    dev = torch.device("cpu") if args.cpu else resolve_device(None)
    params, cfg = load_checkpoint(args.checkpoint, device=dev)
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens,
                           kv_cache_dtype=args.kv_cache_dtype)
    sess = WhisperSession(
        params, cfg, gen,
        RuntimeConfig(compute_dtype=args.dtype,
                      persistent_cache_dir=args.cache_dir or None),
        device=dev)
    if args.backend == "ifb":
        # the weights as loaded, as the JAX daemon hands them over
        server = IfbTranscriptionServer(params, cfg, gen,
                                        num_slots=args.num_slots, device=dev)
    elif args.backend == "sched":
        server = ScheduledTranscriptionServer(
            sess, allowed_batch_sizes=sorted({1, 2, 4, args.num_slots}),
            max_wait_ms=args.max_wait_ms)
    else:
        server = TranscriptionServer(sess, num_slots=args.num_slots)
    return server, cfg


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--port", type=int, default=8080,
                    help="0: a port the OS picks, named on the 'serving on' "
                         "line")
    ap.add_argument("--num-slots", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=224)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"],
                    help="the slots and sched backends' compute dtype")
    ap.add_argument("--kv-cache-dtype", default="auto",
                    choices=["auto", "int8", "fp8"],
                    help="KV-cache storage precision (int8/fp8: per-token "
                         "scales, cross cache T-minor)")
    ap.add_argument("--hf-model", default=None,
                    help="a local directory holding a Whisper tokenizer, "
                         "for text output (never downloaded)")
    ap.add_argument("--backend", default="slots",
                    choices=["slots", "ifb", "sched"],
                    help="slots: utterance-level batch lanes; ifb: token-level "
                         "in-flight batching (continuous); sched: native "
                         "policy scheduler (priorities, deadlines, "
                         "tail-latency guard)")
    ap.add_argument("--max-wait-ms", type=int, default=20,
                    help="sched backend: launch a partial batch once the "
                         "oldest request has waited this long")
    ap.add_argument("--cache-dir", default="",
                    help="directory of the kernels' built libraries (the "
                         "persistent compilation cache); empty: build/kernels")
    ap.add_argument("--cpu", action="store_true",
                    help="serve from the CPU (the plain PyTorch path)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    server, cfg = build_server(args)
    state = {"server": server, "specials": {
        cfg.eos_token_id, cfg.pad_token_id, cfg.decoder_start_token_id,
        *[t for _, t in cfg.forced_decoder_ids],
    }}
    if args.hf_model:
        try:
            from transformers import WhisperTokenizerFast

            state["tokenizer"] = WhisperTokenizerFast.from_pretrained(
                args.hf_model, local_files_only=True)
        except Exception as e:  # noqa: BLE001 — ids are served without it
            print(f"no tokenizer from {args.hf_model}: {e}", file=sys.stderr)

    stop = threading.Event()
    t = threading.Thread(target=scheduler_loop, args=(state, stop), daemon=True)
    t.start()

    httpd = ThreadingHTTPServer(("0.0.0.0", args.port), build_handler(state))
    print(f"serving on :{httpd.server_address[1]} (backend={args.backend}, "
          f"slots={args.num_slots})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        stop.set()


if __name__ == "__main__":
    main()
