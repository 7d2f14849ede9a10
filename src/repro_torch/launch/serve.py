"""Serving driver: batched generation on one device (the card by default).

Usage (reduced config):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --requests 8 --max-new 32 [--device cuda]

The parameters are random, drawn from a ``torch.Generator`` seeded by
``seed`` on the device; the prompts are drawn from numpy's
``default_rng(seed)`` as the reference draws them.  ``seconds`` is the
host clock around ``Engine.generate``, which ends by copying the tokens
to the host, so on the card it includes the device's work.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.models import transformer
from repro_torch.serving.engine import Engine, Request


def run(
    arch: str,
    reduced: bool = True,
    num_requests: int = 8,
    prompt_len: int = 32,
    max_new: int = 32,
    temperature: float = 0.0,
    seed: int = 0,
    device="cuda",
):
    cfg = registry.get(arch)
    if reduced:
        cfg = cfg.reduced()
    device = torch.device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    params = transformer.init_params(cfg, generator, device=device)
    rng = np.random.default_rng(seed)
    requests = [
        Request(
            uid=i,
            prompt=rng.integers(0, cfg.vocab_size, size=prompt_len).astype(
                np.int32
            ),
            max_new_tokens=max_new,
        )
        for i in range(num_requests)
    ]
    engine = Engine(cfg, params, max_len=prompt_len + max_new + 8,
                    temperature=temperature, seed=seed)
    t0 = time.time()
    completions = engine.generate(requests)
    dt = time.time() - t0
    total_new = sum(len(c.tokens) for c in completions)
    return {
        "arch": cfg.name,
        "requests": num_requests,
        "new_tokens": total_new,
        "seconds": dt,
        "tokens_per_second": total_new / dt,
        "sample": completions[0].tokens[:16].tolist(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.list_archs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(
        args.arch,
        num_requests=args.requests,
        prompt_len=args.prompt_len,
        max_new=args.max_new,
        temperature=args.temperature,
        device=args.device,
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
