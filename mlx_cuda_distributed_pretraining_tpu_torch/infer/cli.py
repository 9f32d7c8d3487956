"""Generation CLI: load a trained run's newest verified checkpoint and sample
(temperature, top-p, min-p, repetition penalty), or run beam search or
prompt-lookup speculation. The weights load on ``--device`` (default
``cuda``); ``--weight-quant`` serves them weight-only int8.

    python -m mlx_cuda_distributed_pretraining_tpu_torch.infer.cli \\
        --run myrun --prompt "Once upon a time" --temperature 0
"""

from __future__ import annotations

import argparse


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="Generate from a trained run")
    parser.add_argument("--run", required=True, help="run name or directory")
    parser.add_argument("--runs-root", default="runs")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--prompt", default="")
    parser.add_argument("--max-tokens", type=int, default=128)
    parser.add_argument("--temperature", type=float, default=None,
                        help="sampling temperature (default 0.7; 0 = greedy)")
    parser.add_argument("--top-p", type=float, default=0.0)
    parser.add_argument("--min-p", type=float, default=0.0)
    parser.add_argument("--repetition-penalty", type=float, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--beams", type=int, default=0, help=">0 switches to beam search")
    parser.add_argument("--kv-quant", action="store_true",
                        help="int8-quantized KV cache (less memory per token)")
    parser.add_argument("--speculative", action="store_true",
                        help="prompt-lookup speculation: greedy (identical to "
                             "plain decode) unless --temperature is given, then "
                             "exact rejection-sampled temperature sampling")
    parser.add_argument("--draft-len", type=int, default=8,
                        help="speculative: drafted tokens per verify step")
    parser.add_argument("--weight-quant", action="store_true",
                        help="int8 weight-only quantization (weights cross "
                             "device memory at 1 byte/elem; composes with "
                             "--kv-quant)")
    args = parser.parse_args(argv)

    if args.beams > 0 and args.kv_quant:
        parser.error("--kv-quant is not supported with --beams (beam search "
                     "uses the fp32 cache)")
    if args.speculative and args.beams > 0:
        parser.error("--speculative cannot combine with --beams")
    if args.speculative and (args.top_p or args.min_p
                             or args.repetition_penalty):
        parser.error("--speculative supports greedy or pure-temperature "
                     "sampling only; drop --top-p/--min-p/"
                     "--repetition-penalty")
    from ..train.trainer import load_trained
    from .generate import beam_search, generate_speculative, generate_text

    params, margs, tok, _ = load_trained(args.run, runs_root=args.runs_root,
                                         device=args.device)
    if args.weight_quant:
        from ..models.llama import quantize_params_int8

        params = quantize_params_int8(params)
    if args.speculative:
        ids = [tok.bos_id] + tok.tokenize(args.prompt)
        out, stats = generate_speculative(
            params, margs, ids, max_tokens=args.max_tokens,
            draft_len=args.draft_len, stop_tokens=[tok.eos_id],
            kv_quant=args.kv_quant,
            # greedy unless sampling was asked for explicitly
            temperature=args.temperature or 0.0,
            seed=args.seed,
        )
        text = tok.detokenize(out)
        print(f"[{stats['generation_tps']:.1f} tok/s, "
              f"{stats['tokens_per_call']} tok/verify] {args.prompt}{text}")
        return text
    if args.beams > 0:
        ids = [tok.bos_id] + tok.tokenize(args.prompt)
        seq, score = beam_search(params, margs, ids, num_beams=args.beams,
                                 max_tokens=args.max_tokens, eos_id=tok.eos_id)
        text = tok.detokenize(seq)
        print(f"[beam score {score:.3f}] {args.prompt}{text}")
        return text
    text = generate_text(
        params, margs, tok, args.prompt,
        max_new_tokens=args.max_tokens,
        temperature=0.7 if args.temperature is None else args.temperature,
        top_p=args.top_p, min_p=args.min_p,
        repetition_penalty=args.repetition_penalty, seed=args.seed,
        kv_quant=args.kv_quant,
    )
    print(args.prompt + text)
    return text


if __name__ == "__main__":
    main()
