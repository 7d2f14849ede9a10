"""gemma-2b — dense decoder, GeGLU, head_dim=256, MQA.

[arXiv:2403.08295] 18L, d_model=2048, 8H with a SINGLE kv head (MQA),
head_dim=256 (so q/k/v are wider than d_model), d_ff=16384 (GeGLU),
vocab=256000, tied embeddings. Pure full attention => long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    arch_type="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    source="arXiv:2403.08295",
    attention="gqa",
    mlp="geglu",
    scale_embeddings=True,
    tie_embeddings=True,
    max_seq_len=8192,
)
