"""zamba2-2.7b — hybrid Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242] 54 Mamba2 layers, d_model=2560; a single *shared*
transformer block (32H GQA kv=32, d_ff=10240) is applied every 6 SSM
layers, reusing one set of weights (the Zamba trick: attention quality at
~1/9th of the attention parameter cost). ssm_state=64.
"""

from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    source="arXiv:2411.15242",
    attention="gqa",
    mlp="geglu",
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk_size=64),
    shared_attn_every=6,
    max_seq_len=524288,
)
