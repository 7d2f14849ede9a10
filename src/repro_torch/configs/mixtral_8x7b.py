"""mixtral-8x7b — sparse MoE decoder, 8 experts top-2, SWA.

[arXiv:2401.04088] 32L, d_model=4096, 32H (GQA kv=8), per-expert
d_ff=14336, vocab=32000, sliding window 4096 on all layers. Every MLP is
replaced by an 8-expert top-2 router — the expert-parallel all-to-all is
this arch's dominant collective.
"""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=32000,
    source="arXiv:2401.04088",
    attention="gqa",
    sliding_window=4096,
    mlp="swiglu",
    moe=MoEConfig(num_experts=8, experts_per_token=2, d_ff=14336),
    max_seq_len=524288,
)
