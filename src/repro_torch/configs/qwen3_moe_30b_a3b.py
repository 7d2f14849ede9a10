"""qwen3-moe-30b-a3b — fine-grained sparse MoE, 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B] 48L, d_model=2048, 32H (GQA kv=4, head_dim=128),
per-expert d_ff=768, vocab=151936. 30B total / ~3B active parameters.
Full attention => long_500k skipped; the 128-way expert dispatch makes
this the most collective-bound assigned pair (see EXPERIMENTS.md).
"""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151936,
    source="hf:Qwen/Qwen3-30B-A3B",
    attention="gqa",
    rope_theta=1e6,
    mlp="swiglu",
    moe=MoEConfig(num_experts=128, experts_per_token=8, d_ff=768),
    max_seq_len=32768,
)
