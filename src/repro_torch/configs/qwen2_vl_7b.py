"""qwen2-vl-7b — VLM language backbone with M-RoPE.

[arXiv:2409.12191] 28L, d_model=3584, 28H (GQA kv=4), d_ff=18944,
vocab=152064. Multimodal rotary position embedding: head_dim=128 split
into (16, 24, 24) frequency sections carrying (temporal, height, width)
positions. The ViT/dynamic-resolution frontend is the mandated STUB —
input_specs() provides patch embeddings.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    arch_type="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    source="arXiv:2409.12191",
    attention="gqa",
    mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    mlp="swiglu",
    modality="vision",
    frontend_tokens=256,  # image patch embeddings per request
    max_seq_len=32768,
)
