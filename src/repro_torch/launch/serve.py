"""Serving launcher CLI: batched prefill + decode on a reduced config, on
the card (or the CPU).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --batch 4 --prompt-len 64 --new-tokens 32

The same flags as the JAX package's ``repro.launch.serve``, plus
``--device`` (default: CUDA; ``--device cpu`` runs on the CPU).  Every
decoder family the port runs is served: dense, MoE (``qwen2-moe-a2.7b``,
``qwen3-moe-235b-a22b``), the RG-LRU hybrid (``recurrentgemma-2b``),
xLSTM (``xlstm-125m``) and the M-RoPE VLM (``qwen2-vl-72b``, its prompts
a quarter vision patches from the stub); the encoder-only
``hubert-xlarge`` has nothing to decode and exits, as in the reference.
Like the
reference, the CLI always serves the reduced config with the config's
``attn_impl`` (logged in ROADMAP Queue C); a full-width run, or one
through the kernels, goes through :class:`ServingEngine` directly, as
``chip_smoke.py`` does.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import REGISTRY, get
from repro_torch.configs.base import InputShape
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params, make_batch
from repro_torch.serve import ServingEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=sorted(REGISTRY))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    cfg = get(args.arch).reduced()
    if not cfg.causal:
        raise SystemExit(f"{cfg.name} is encoder-only; nothing to decode")
    dev = resolve_device(args.device)
    params = init_params(cfg, seed=args.seed, device=dev)
    engine = ServingEngine(cfg, params,
                           cache_len=args.prompt_len + args.new_tokens)
    shape = InputShape("serve", args.prompt_len, args.batch, "prefill")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    batch = make_batch(cfg, shape, gen)

    t0 = time.perf_counter()
    result = engine.generate(batch, args.new_tokens,
                             temperature=args.temperature, seed=args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} device={dev} "
          f"batch={args.batch} prompt={args.prompt_len} "
          f"new={args.new_tokens}")
    print(f"tokens[0] = {result.tokens[0].tolist()}")
    print(f"mean logprob = {float(result.logprobs.mean()):.3f}")
    print(f"wall {dt:.2f}s -> {args.batch * args.new_tokens / dt:.1f} tok/s "
          f"(reduced, {dev.type})")


if __name__ == "__main__":
    main()
