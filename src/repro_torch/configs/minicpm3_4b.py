"""minicpm3-4b — dense decoder with Multi-head Latent Attention.

[hf:openbmb/MiniCPM3-4B] 62L, d_model=2560, 40 heads (kv=40), d_ff=6400,
vocab=73448. MLA compresses the KV cache into a 256-d latent (+32-d
decoupled RoPE key), the property DESIGN.md flags as the best offload
case: tiny per-step state crossing the network.
"""

from repro_torch.configs.base import ArchConfig, MLAConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    arch_type="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    source="hf:openbmb/MiniCPM3-4B",
    attention="mla",
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    mlp="swiglu",
    max_seq_len=32768,
)
