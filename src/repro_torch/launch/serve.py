"""Batched serving driver: prefill a batch of prompts, then greedy-decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --batch 4 --prompt-len 64 --decode 32 [--full] [--device cpu]

The port of ``repro/launch/serve.py``. It runs on the CUDA card unless
``--device`` names another, with ``use_pallas=True``: the port's flash
attention kernel in every prefill attention (the SSM prefill runs the
plain chunked scan, as in the reference). Parameters and prompts come from
a seeded ``torch.Generator``; no weights are read.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.device import resolve_device
from repro_torch.models import count_params, decode_step, init_params
from repro_torch.serve import make_prefill_step
from repro_torch.sharding.specs import ShardingRules

RULES = ShardingRules(batch=None, fsdp=None, tp=None)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, tokens, n_decode: int) -> dict:
    """Prefill ``tokens`` [B, S], then ``n_decode - 1`` greedy steps, with
    KV buffers of S + n_decode. Each step is ``decode_step`` and the
    argmax of its logits, which is ``make_serve_step``'s step with the
    logits kept.

    Returns {"tokens": [B, n_decode] int32 (the first from the prefill's
    logits), "logits": [n_decode, B, V] f32, "prefill_s", "decode_s"}; the
    times are host seconds that end in a device synchronise."""
    device = tokens.device
    prefill_step = make_prefill_step(cfg, RULES,
                                     t_max=tokens.shape[1] + n_decode)
    _sync(device)
    t0 = time.perf_counter()
    state, logits = prefill_step(params, {"tokens": tokens})
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    _sync(device)
    t_prefill = time.perf_counter() - t0
    out_tokens, out_logits = [tok], [logits]
    t0 = time.perf_counter()
    for _ in range(n_decode - 1):
        logits, state = decode_step(cfg, RULES, params, state, tok)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out_tokens.append(tok)
        out_logits.append(logits)
    _sync(device)
    return {
        "tokens": torch.cat(out_tokens, dim=1),
        "logits": torch.stack(out_logits),
        "prefill_s": t_prefill,
        "decode_s": time.perf_counter() - t0,
    }


def main(argv=None) -> dict:
    """Serve as the command line says; prints and returns the numbers."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode", type=int, default=32)
    ap.add_argument("--full", action="store_true",
                    help="serve the full config instead of the reduced one")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch) if args.full else reduced(get_arch(args.arch))
    cfg = dataclasses.replace(cfg, use_pallas=True)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device, dtype=torch.int32)
    res = generate(cfg, params, tokens, args.decode)
    steps = args.decode - 1
    tput = args.batch * steps / max(res["decode_s"], 1e-9)
    n_params = count_params(cfg)
    out = {
        "arch": cfg.name, "device": str(device), "batch": args.batch,
        "prompt_len": args.prompt_len, "decode_steps": steps,
        "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
        "decode_tok_s": tput, "params": n_params,
        "param_gb": n_params * 4 / 1e9,
        "sample_tokens": res["tokens"][0, :16].tolist(),
    }
    t_prefill = res["prefill_s"]
    print(f"arch={cfg.name} on {device}: prefill {args.batch}x"
          f"{args.prompt_len} in {t_prefill:.2f}s; decode {steps} "
          f"steps @ {tput:.1f} tok/s")
    print("sample token ids:", out["sample_tokens"])
    return out


if __name__ == "__main__":
    main()
