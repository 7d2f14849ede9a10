"""The paper's technique generalized: tiered edge serving of LLM decode.

    PYTHONPATH=src python -m repro_torch.examples.llm_edge_decode [--device cuda]

Autoregressive decode has the hand tracker's exact structure (Fig. 3
category A: serial steps, small recurrent payload, heavy compute core).
This example (1) REALLY serves a reduced gemma-2b with the batched
engine on ``--device``, then (2) plans client/edge placement for all ten
assigned architectures with the Local/Forced/Auto policies, showing how
the per-step state payload (SSM constant state, MLA latent cache, MQA
single head) decides offloadability, and (3) places the decode step on a
device -> edge -> cloud chain.  Parts 2 and 3 are host code and print
what the reference's example prints.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.offload import Policy
from repro_torch.models import transformer
from repro_torch.serving import edge
from repro_torch.serving.engine import Engine, Request
from repro_torch.sim import hardware


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "this CPU"


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)

    # --- part 1: real batched serving of a reduced model ---
    cfg = registry.get("gemma-2b").reduced()
    params = transformer.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    rng = np.random.default_rng(0)
    requests = [
        Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, 16).astype(np.int32),
                max_new_tokens=24)
        for i in range(8)
    ]
    engine = Engine(cfg, params, max_len=64)
    t0 = time.perf_counter()
    completions = engine.generate(requests)  # ends by copying tokens to the host
    dt = time.perf_counter() - t0
    total = sum(len(c.tokens) for c in completions)
    print(f"served {len(requests)} requests, {total} tokens "
          f"in {dt:.2f}s ({total / dt:.1f} tok/s on {_device_name(device)})")
    print(f"sample completion: {completions[0].tokens[:12].tolist()}\n")

    # --- part 2: edge placement across the assigned architectures ---
    env = hardware.edge_tpu_environment()
    print(f"thin client ({env.client.name}) -> edge TPU over {env.link.name}")
    print(f"{'arch':24s} {'local':>9s} {'forced':>9s} {'auto':>9s} "
          f"{'state/tok':>10s}  policy_choice")
    rows = edge.compare_archs([registry.get(a) for a in registry.list_archs()], env)
    for name, r in rows.items():
        choice = "offload" if r["forced"] >= r["local"] else "local"
        print(f"{name:24s} {r['local']:9.2f} {r['forced']:9.2f} "
              f"{r['auto']:9.2f} {r['state_bytes'] / 1024:9.1f}K  {choice}")
    print("\ntok/s per policy; Auto always matches the best (paper's claim).")

    # --- part 3: device -> edge -> cloud chain (the multi-machine scaling
    # the paper flags as future work). 18 stages x 3 tiers = 3^18 candidate
    # plans — AUTO routes through the exact O(n*k^2) chain-DP planner.
    topo = hardware.three_tier_environment()
    print(f"\n3-tier chain: {' -> '.join(topo.tier_names())} "
          f"({' + '.join(l.name for l in topo.links.values())})")
    print(f"{'arch':24s} {'auto tok/s':>10s}  placement (embed..head)")
    for arch in ("gemma-2b", "mamba2-370m", "mixtral-8x7b"):
        ep = edge.plan_decode(
            registry.get(arch), topo, Policy.AUTO,
            granularity="multi_step", num_stage_groups=16,
        )
        tags = "".join(p[0].upper() for p in ep.report.placements)
        print(f"{arch:24s} {ep.tokens_per_second:10.2f}  {tags}")
    print("\nD=device, E=edge, C=cloud per stage; the DP prices every "
          "hop of the chain.")


if __name__ == "__main__":
    main()
