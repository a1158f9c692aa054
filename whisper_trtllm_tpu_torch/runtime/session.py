"""Serving session: device-resident weights, audio or mel in, token ids and
lengths out (counterpart of ``whisper_trtllm_tpu/runtime/session.py``).

With a ``mesh`` (``parallel.make_mesh``) the session holds this rank's
shards of the weights (``shard_params`` after the load-time chain) and
runs inside its mesh: each data rank transcribes its rows of the batch,
the model ranks join their partial sums, and every rank returns the whole
batch's tokens and lengths.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from whisper_trtllm_tpu_torch.audio.features import LogMelSpectrogram, pad_or_trim
from whisper_trtllm_tpu_torch.config import (
    GenerationConfig,
    RuntimeConfig,
    WhisperConfig,
)
from whisper_trtllm_tpu_torch import quantization
from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
from whisper_trtllm_tpu_torch.parallel.mesh import (
    check_mesh,
    join_batch,
    split_batch,
)
from whisper_trtllm_tpu_torch.parallel.partition import shard_params
from whisper_trtllm_tpu_torch.runtime import beam
from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
from whisper_trtllm_tpu_torch.utils.checkpoint import (
    init_compilation_cache,
    params_from_numpy,
)
from whisper_trtllm_tpu_torch.utils.device import (
    resolve_device,
    set_fp32_precision,
    to_tensor,
)

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# RuntimeConfig.weight_dtype → the tree rewrite of the load-time chain
_WEIGHT_QUANTIZERS = {"native": None,
                      "int8": quantization.weight_only_quantize,
                      "int4": quantization.weight_only_quantize_int4,
                      "fp8": quantization.fp8_quantize}


def _check_runtime(rt: RuntimeConfig) -> None:
    """Refuse an unknown ``weight_dtype`` (``ValueError``, as the JAX
    session does) and a ``compute_dtype`` other than float32 or bfloat16.

    Every other option is taken, as the JAX session takes it:

    - ``fp32_attention_softmax``, ``fp32_logits`` and ``use_pallas`` change
      nothing. The JAX package declares them and never reads them (its
      attention picks Pallas from the backend, not from the config), so
      either value decodes the same there, and here. ``use_pallas=False``
      does not switch the kernels off.
    - ``donate_caches``: the port's decode writes its caches in place, one
      set a decode (or a captured step's), which is what donation buys the
      JAX loop, so either value runs the same decode.
    - ``persistent_cache_dir`` is where the kernels' libraries are built
      and found (``utils.checkpoint.init_compilation_cache``), the
      counterpart of XLA's persistent compilation cache.
    """
    if rt.weight_dtype not in _WEIGHT_QUANTIZERS:
        raise ValueError(f"unknown weight_dtype {rt.weight_dtype!r}; "
                         f"expected native/int8/int4/fp8")
    if rt.compute_dtype not in _COMPUTE_DTYPES:
        raise NotImplementedError(
            f"RuntimeConfig options not ported yet: compute_dtype "
            f"{rt.compute_dtype!r} (float32 or bfloat16)")


class WhisperSession:
    """End-to-end ASR serving: audio/mel in, token ids (+ lengths) out, on
    one device or over a ``mesh`` of this device type. ``device`` defaults
    to the CUDA card."""

    def __init__(
        self,
        params: dict,
        cfg: WhisperConfig,
        generation: Optional[GenerationConfig] = None,
        runtime: Optional[RuntimeConfig] = None,
        mesh=None,
        device=None,
    ):
        self.device = resolve_device(device)
        check_mesh(mesh)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"the mesh lies on {mesh.device_type}, the "
                             f"session on {self.device}")
        self.mesh = mesh
        set_fp32_precision()
        self.cfg = cfg
        self.generation = generation or GenerationConfig()
        self.runtime = runtime or RuntimeConfig()
        _check_runtime(self.runtime)
        if self.runtime.persistent_cache_dir:
            init_compilation_cache(self.runtime.persistent_cache_dir)
        if self.generation.num_beams > 1:
            beam.check_early_stopping(self.generation)
        else:
            gen_rt.check_greedy_config(self.generation)
            gen_rt.check_data_axis(self.generation, mesh)
        self._dtype = _COMPUTE_DTYPES[self.runtime.compute_dtype]
        self.params = self._prepare_params(params)
        self.frontend = LogMelSpectrogram(cfg.num_mel_bins, dtype=self._dtype,
                                          device=self.device)

    def _prepare_params(self, params: dict) -> dict:
        """The load-time chain, shared by ``__init__`` and ``refit``: fuse
        q/k/v (``fuse_qkv``) → quantization of the dense projections
        (``weight_dtype`` "int8", "int4" or "fp8") → int8 vocab table
        (``quantize_vocab``) → placement on the session's device and cast
        of the float leaves wider than a byte to the compute dtype (scales
        and SmoothQuant's ``smooth`` included; int8, packed int4 and fp8
        kernels keep their type and dequantize in ``dense``). A SmoothQuant
        tree comes from ``quantization.smooth_quantize_whisper``, made by
        the caller, as in the JAX package. With a mesh, this rank's shards of
        the result."""
        rt = self.runtime
        if rt.fuse_qkv:
            params = wmodel.fuse_qkv_params(params)
        quantize = _WEIGHT_QUANTIZERS[rt.weight_dtype]
        if quantize is not None:
            params = quantize(params)
        if rt.quantize_vocab:
            params = quantization.quantize_vocab_embedding(params)
        params = wmodel.cast_params(params_from_numpy(params, self.device),
                                    self._dtype)
        if self.mesh is not None:
            return shard_params(params, self.mesh, cfg=self.cfg)
        return params

    def _in_mesh(self):
        return self.mesh if self.mesh is not None else contextlib.nullcontext()

    @torch.inference_mode()
    def _run(self, mel: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """Encode this rank's rows, then the greedy decode, or with
        ``num_beams > 1`` the beam search's best hypothesis (greedy's
        signature, as in the JAX session); the whole batch's result."""
        with self._in_mesh():
            enc = wmodel.encode(self.params, self.cfg, mel.to(self._dtype))
            if self.generation.num_beams > 1:
                tokens, _, lengths = beam.beam_decode(
                    self.params, self.cfg, enc, self.generation)
                tokens, lengths = tokens[:, 0], lengths[:, 0]
            else:
                tokens, lengths = gen_rt.greedy_decode(
                    self.params, self.cfg, enc, self.generation)
            tokens = join_batch(tokens, self.mesh)
            lengths = join_batch(lengths, self.mesh)
        return tokens.cpu().numpy(), lengths.cpu().numpy()

    def _rows(self, x):
        """This rank's rows of a batch (all of them without a mesh)."""
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        return split_batch(x, self.mesh)

    # -- public API -----------------------------------------------------------
    def transcribe_features(self, mel) -> Tuple[np.ndarray, np.ndarray]:
        """mel (B, 3000, n_mels) → (tokens (B, max_len), lengths (B,))."""
        return self._run(to_tensor(self._rows(mel), self.device))

    def transcribe(self, audio) -> Tuple[np.ndarray, np.ndarray]:
        """Raw 16 kHz audio (B, n_samples) → (tokens, lengths); pads or
        trims to 30 s and runs the frontend on the device."""
        audio = self._rows(np.atleast_2d(np.asarray(audio, np.float32)))
        with torch.inference_mode():
            mel = self.frontend(pad_or_trim(audio))
        return self._run(mel)

    @torch.inference_mode()
    def encode(self, mel) -> torch.Tensor:
        """Encoder states of the rows given (not cut over a data axis)."""
        mel = to_tensor(mel, self.device, self._dtype)
        with self._in_mesh():
            return wmodel.encode(self.params, self.cfg, mel)

    def refit(self, params: dict) -> None:
        """Swap in new weights: the tree goes through the same load-time
        chain (``_prepare_params``), so it has the structure the session
        runs, then replaces the old weights. The decode steps captured
        against the old weights are dropped: a CUDA graph reads the
        weights it was captured with, and the next decode captures anew."""
        new = self._prepare_params(params)
        gen_rt.drop_graphs(self.params)
        self.params = new

    def memory_stats(self) -> dict:
        """Device memory in use, its peak, and the card's size (None for
        each on the CPU)."""
        if self.device.type != "cuda":
            return {"bytes_in_use": None, "peak_bytes_in_use": None,
                    "bytes_limit": None}
        stats = torch.cuda.memory_stats(self.device)
        return {
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(
                self.device).total_memory,
        }

    def warmup(self, batch: int = 1) -> None:
        """Build the kernels and run the pipeline once at this batch size;
        on the card that captures the decode step's CUDA graph for it (the
        beam step's with ``num_beams > 1``)."""
        mel = torch.zeros((batch, 2 * self.cfg.max_source_positions,
                           self.cfg.num_mel_bins), device=self.device)
        self._run(self._rows(mel))

    def export_engine(self, path: str, batch: int = 1) -> int:
        """Write the greedy transcribe pipeline at this batch size to one
        engine file (``utils/engine.py``: two ``torch.export`` programs,
        encode and the decode step) and return its size in bytes. The
        engine takes (params, mel), so any tree of this session's
        structure runs through it (``sess.params``, or a refit tree made
        by the same chain); ``utils.engine.load_engine`` reads it without
        the model code. On the card the programs call K1, K2, K5 and K6 as
        ``torch.ops.wtpu.*``. Beam search (``num_beams > 1``) is not
        exported."""
        if self.generation.num_beams > 1:
            raise NotImplementedError(
                "export_engine exports the greedy pipeline; beam search "
                "(num_beams > 1) is not exported")
        if self.mesh is not None:
            raise NotImplementedError(
                "export_engine exports the one-device pipeline; a session "
                "over a mesh is not exported")
        from whisper_trtllm_tpu_torch.runtime.export import export_programs
        from whisper_trtllm_tpu_torch.utils.engine import save_engine

        return save_engine(path, *export_programs(
            self.params, self.cfg, self.generation, self._dtype, self.device,
            batch))
