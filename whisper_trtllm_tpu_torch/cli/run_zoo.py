"""Run a zoo causal-LM: prompt in, generated tokens (and text) out
(counterpart of the repository's ``cli/run_zoo.py``), on the CUDA card
(``--cpu``: the plain PyTorch path on the CPU).

The families gpt, opt, llama, gptj, gptneox, bloom and chatglm6b.
``--prompt-ids`` takes raw token ids (no tokenizer needed); ``--hf-model``
converts a local HF checkpoint directory (nothing is fetched) and, when it
holds tokenizer files, tokenizes ``--prompt`` and detokenizes the output.
ChatGLM-6B has no transformers class (it is a trust_remote_code model):
``--hf-model`` refuses it, as the JAX CLI does, and
``models.chatglm6b.convert_hf_chatglm6b`` takes its state dict.

Examples:
  python -m whisper_trtllm_tpu_torch.cli.run_zoo --family gpt \\
      --prompt-ids 15496 11 995 --max-new-tokens 32
  python -m whisper_trtllm_tpu_torch.cli.run_zoo --config gpt_350m \\
      --prompt-ids 1 2 3 --sample --temperature 0.8 --top-p 0.95
  python -m whisper_trtllm_tpu_torch.cli.run_zoo --family llama \\
      --hf-model /ckpts/llama-7b --prompt "The capital of France is"

Prints one JSON line: the family, the prompt's length and the output ids
(and the text with a tokenizer).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

_FAMILIES = ("gpt", "llama", "opt", "gptj", "gptneox", "bloom", "chatglm6b")

_CONVERTERS = {
    "gpt": ("convert_hf_gpt2", "GPT2LMHeadModel"),
    "llama": ("convert_hf_llama", "LlamaForCausalLM"),
    "opt": ("convert_hf_opt", "OPTForCausalLM"),
    "gptj": ("convert_hf_gptj", "GPTJForCausalLM"),
    "gptneox": ("convert_hf_gptneox", "GPTNeoXForCausalLM"),
    "bloom": ("convert_hf_bloom", "BloomForCausalLM"),
}


def main(argv=None):
    from whisper_trtllm_tpu_torch.benchmarks.allowed_configs import (
        build_model,
        config_class,
        family_module,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--family", choices=_FAMILIES,
                     help="run with testing-width random weights")
    src.add_argument("--config", help="a benchmarks/allowed_configs.py name")
    ap.add_argument("--hf-model", default=None,
                    help="local HF checkpoint directory to convert (weights "
                         "and config; the tokenizer if present)")
    ap.add_argument("--prompt", default=None, help="text (needs a tokenizer)")
    ap.add_argument("--prompt-ids", type=int, nargs="+", default=None)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--repetition-penalty", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    if args.config:
        fam, cfg, init_params, generate, _ = build_model(args.config)
        mod = family_module(fam)
    else:
        fam = args.family
        mod = family_module(fam)
        cfg = None if args.hf_model else config_class(fam).testing()
        init_params, generate = mod.init_params, mod.generate
    if generate is None:
        raise SystemExit(f"{fam} has no generate() (encoder-only)")

    tokenizer = None
    if args.hf_model:
        import transformers

        if fam not in _CONVERTERS:
            raise SystemExit(
                f"{fam}: no transformers-class converter (chatglm-6b is a "
                "trust_remote_code model; use models.chatglm6b."
                "convert_hf_chatglm6b on its state_dict directly)")
        conv_name, hf_cls = _CONVERTERS[fam]
        hf = getattr(transformers, hf_cls).from_pretrained(
            args.hf_model, local_files_only=True)
        params, cfg = getattr(mod, conv_name)(hf, device=device)
        try:
            tokenizer = transformers.AutoTokenizer.from_pretrained(
                args.hf_model, local_files_only=True)
        except Exception:
            tokenizer = None
    else:
        params = init_params(cfg, seed=0, device=device)

    if args.prompt_ids is not None:
        ids = np.asarray([args.prompt_ids], np.int32)
    elif args.prompt is not None and tokenizer is not None:
        ids = np.asarray([tokenizer.encode(args.prompt)], np.int32)
    else:
        raise SystemExit("need --prompt-ids, or --prompt with a tokenizer "
                         "(an --hf-model directory holding tokenizer files)")

    # every knob passes through; make_sampling_cfg decides whether the
    # call draws (--sample alone: a temperature-1 draw; a repetition
    # penalty alone: penalized greedy)
    out = generate(params, cfg, ids, max_new_tokens=args.max_new_tokens,
                   temperature=args.temperature, top_k=args.top_k,
                   top_p=args.top_p,
                   repetition_penalty=args.repetition_penalty,
                   seed=args.seed, do_sample=args.sample, device=device)
    out = out.cpu().numpy()
    row = {"family": fam, "prompt_len": int(ids.shape[1]),
           "output_ids": out[0].tolist()}
    if tokenizer is not None:
        row["text"] = tokenizer.decode(out[0], skip_special_tokens=True)
    print(json.dumps(row))


if __name__ == "__main__":
    main()
