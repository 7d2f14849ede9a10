"""gemma3-4b — dense decoder with 5:1 local:global attention, 128k ctx.

[hf:google/gemma-3-1b-pt family, 4b point] 34L, d_model=2560, 8H (GQA
kv=4, head_dim=256), d_ff=10240 (GeGLU), vocab=262144. Attention pattern:
period 6 = five sliding-window (1024) layers then one global layer —
which is what qualifies it for long_500k (global layers are linear per
decoded token; local layers bound the cache).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    arch_type="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    source="hf:google/gemma-3-1b-pt",
    attention="gqa",
    rope_theta=1e6,
    sliding_window=1024,
    attn_pattern_period=6,
    global_layers_per_period=1,
    mlp="geglu",
    scale_embeddings=True,
    tie_embeddings=True,
    max_seq_len=524288,
)
