"""Serving example on the PyTorch port: batched prefill + decode across
architecture families.

The port's copy of ``examples/serving.py``.  Serves three reduced
architectures — dense GQA (llama3.2-1b), hybrid RG-LRU (recurrentgemma-2b)
and SSM (xlstm-125m) — through the same ServingEngine API, demonstrating
that KV caches, ring buffers and recurrent states all hide behind one
decode interface.  Greedy decoding is checked to be deterministic, and a
sampled run to differ from it.  The reduced configs keep the reference's
``attn_impl="ref"``, so attention takes the plain route as it does in the
reference example.  Parameters and prompts come from seeded
``torch.Generator``s (``jax.random.PRNGKey`` in the reference).

Run:  PYTHONPATH=src python examples/serving_torch.py [--device cpu]
          [--batch 4] [--prompt-len 48] [--new-tokens 24]

Runs on CUDA unless ``--device cpu`` is given.
"""

import argparse
import time

import torch

from repro_torch.configs import get
from repro_torch.configs.base import InputShape
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params, make_batch
from repro_torch.serve import ServingEngine

ARCHS = ["llama3.2-1b", "recurrentgemma-2b", "xlstm-125m"]


def main(device=None, batch: int = 4, prompt_len: int = 48,
         n_new: int = 24) -> dict:
    dev = resolve_device(device)
    out = {}
    for arch in ARCHS:
        cfg = get(arch).reduced()
        params = init_params(cfg, seed=0, device=dev)
        engine = ServingEngine(cfg, params, cache_len=prompt_len + n_new)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        req = make_batch(cfg, InputShape("s", prompt_len, batch, "prefill"),
                         gen)

        t0 = time.perf_counter()
        res = engine.generate(req, n_new)          # greedy
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0

        res2 = engine.generate(req, n_new)         # determinism check
        assert torch.equal(res.tokens, res2.tokens)
        sampled = engine.generate(req, n_new, temperature=0.8, seed=3)
        differs = not torch.equal(res.tokens, sampled.tokens)

        print(f"{arch:22s} [{cfg.family:6s}] "
              f"{batch * n_new / dt:6.1f} tok/s  "
              f"greedy[0,:8]={res.tokens[0, :8].tolist()}  "
              f"mean_lp={float(res.logprobs.float().mean()):.2f}  "
              f"sampled_differs={differs}")
        out[arch] = {"tokens": res.tokens, "logprobs": res.logprobs,
                     "sampled_differs": differs, "seconds": dt}
    print("serving: all families decode through one engine API")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=24)
    args = ap.parse_args()
    main(device=args.device, batch=args.batch, prompt_len=args.prompt_len,
         n_new=args.new_tokens)
