"""starcoder2-3b — dense code model, GQA + RoPE + 4k sliding window.

[arXiv:2402.19173] 30L, d_model=3072, 24H (GQA kv=2), d_ff=12288,
vocab=49152, layernorm + plain GeLU MLP, sliding_window=4096 on every
layer (which is what qualifies it for the long_500k decode shape).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    arch_type="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    source="arXiv:2402.19173",
    attention="gqa",
    rope_theta=1e5,
    sliding_window=4096,
    mlp="gelu",
    norm="layernorm",
    max_seq_len=524288,
)
