"""Tiered edge serving for LLM decode — the paper's technique generalized.

An autoregressive decode step has the same structure as the tracker's
per-frame optimization: a serially-dependent step with a small recurrent
payload (the sampled token + per-step cache delta) and a heavy compute
core (the layer stack). This module builds the byte/FLOP-annotated
``StagedComputation`` of one decode step for any assigned architecture
and lets the Local/Forced/Auto policies place its stages across any
tier topology — the paper's thin client -> edge server (TPU pod) pair,
or a device -> edge GPU -> cloud TPU chain
(sim.hardware.three_tier_environment), exactly as the paper places the
hand tracker's four stages across laptop and server.

The per-arch state payload is where the assigned architectures differ
most interestingly (DESIGN.md §Arch-applicability):

* mamba2/zamba2  — O(1) recurrent state: the paper's future-work wish.
* minicpm3 (MLA) — 288 f/token cache delta vs 5120 for equivalent GQA.
* gemma (MQA)    — single KV head: smallest delta among GQA archs.
* mixtral/qwen3  — expert weights pin the heavy stage to the server.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.core import offload
from repro_torch.core.offload import EnvironmentLike, PlanReport, Policy
from repro_torch.core.stages import CLIENT, DataItem, Stage, StagedComputation


def _bytes_per_param(cfg: ArchConfig) -> int:
    return 2 if cfg.dtype == "bfloat16" else 4


def decode_flops(cfg: ArchConfig, batch: int) -> float:
    """~2 * N_active FLOPs per token per sequence (matmul-dominated),
    plus attention's cache-linear term handled separately by caller."""
    return 2.0 * cfg.active_param_count() * batch


def cache_delta_bytes(cfg: ArchConfig, batch: int) -> int:
    """Bytes of per-step recurrent payload if the step crosses machines."""
    bpe = _bytes_per_param(cfg)
    if cfg.arch_type in ("ssm", "hybrid"):
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        n_heads = d_inner // s.head_dim
        per_layer = (
            (s.d_conv - 1) * (d_inner + 2 * s.n_groups * s.d_state) * bpe
            + n_heads * s.head_dim * s.d_state * 4
        )
        total = cfg.num_layers * per_layer
        if cfg.arch_type == "hybrid":
            g = cfg.num_layers // cfg.shared_attn_every
            total += g * 2 * cfg.num_kv_heads * cfg.resolved_head_dim * bpe
        return int(total * batch)
    if cfg.attention == "mla":
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        return int(cfg.num_layers * per_tok * bpe * batch)
    per_tok = 2 * cfg.num_kv_heads * cfg.resolved_head_dim
    return int(cfg.num_layers * per_tok * bpe * batch)


def build_decode_staged(
    cfg: ArchConfig, batch: int = 1, num_stage_groups: int = 4
) -> StagedComputation:
    """One decode step as `num_stage_groups` offloadable layer groups plus
    embed and head stages (the LLM analogue of the tracker's 4 steps)."""
    bpe = _bytes_per_param(cfg)
    d = cfg.d_model
    act_bytes = batch * d * bpe
    token_bytes = batch * 4
    layer_flops = decode_flops(cfg, batch) / max(num_stage_groups, 1)
    delta_bytes = cache_delta_bytes(cfg, batch) // max(num_stage_groups, 1)

    sources = (
        DataItem("token", token_bytes, CLIENT),
        DataItem("rng", 8, CLIENT),
    )
    stages: List[Stage] = [
        Stage(
            name="embed",
            flops=2.0 * batch * d,
            inputs=("token",),
            outputs=(DataItem("h_0", act_bytes),),
            parallel_fraction=0.5,
        )
    ]
    for g in range(num_stage_groups):
        # NOTE: each group's KV/state delta stays resident where the group
        # runs (residency tracking handles it); the hidden activation is
        # what crosses a placement boundary.
        stages.append(
            Stage(
                name=f"layers_{g}",
                flops=layer_flops,
                inputs=(f"h_{g}",),
                outputs=(DataItem(f"h_{g + 1}", act_bytes),),
                parallel_fraction=0.99,
            )
        )
    head_flops = 2.0 * batch * d * cfg.vocab_size
    stages.append(
        Stage(
            name="head_sample",
            flops=head_flops,
            inputs=(f"h_{num_stage_groups}", "rng"),
            outputs=(DataItem("next_token", token_bytes),),
            parallel_fraction=0.95,
        )
    )
    comp = StagedComputation(
        name=f"{cfg.name}_decode_step",
        sources=sources,
        stages=tuple(stages),
        results=("next_token",),
    )
    comp.validate()
    return comp


@dataclasses.dataclass
class EdgePlan:
    arch: str
    policy: Policy
    report: PlanReport
    tokens_per_second: float


def plan_decode(
    cfg: ArchConfig,
    env: EnvironmentLike,
    policy: Policy = Policy.AUTO,
    batch: int = 1,
    granularity: str = "single_step",
    num_stage_groups: int = 4,
) -> EdgePlan:
    """Place one decode step across the tiers of ``env`` (the two-tier
    ``Environment`` shim or a full ``Topology`` chain/star).

    ``num_stage_groups`` controls pipeline depth: the decode chain is a
    linear StagedComputation, so at depths where the plan lattice
    (k_tiers ** n_stages) outgrows exhaustive search AUTO switches to
    the exact O(n*k^2) chain-DP planner."""
    comp = build_decode_staged(cfg, batch, num_stage_groups)
    comp = comp.fused() if granularity == "single_step" else comp
    rep = offload.plan(comp, env, policy)
    return EdgePlan(
        arch=cfg.name,
        policy=policy,
        report=rep,
        tokens_per_second=batch / rep.total_time,
    )


def compare_archs(
    cfgs: List[ArchConfig], env: EnvironmentLike, batch: int = 1
) -> Dict[str, Dict[str, float]]:
    """Token rates for Local/Forced/Auto per arch — the LLM Fig. 5."""
    out = {}
    for cfg in cfgs:
        row = {}
        for pol in (Policy.LOCAL, Policy.FORCED, Policy.AUTO):
            try:
                row[pol.value] = plan_decode(cfg, env, pol, batch).tokens_per_second
            except ValueError:
                row[pol.value] = float("nan")
        row["state_bytes"] = float(cache_delta_bytes(cfg, 1))
        out[cfg.name] = row
    return out
