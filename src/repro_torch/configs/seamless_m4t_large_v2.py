"""seamless-m4t-large-v2 — speech/text encoder-decoder backbone.

[arXiv:2308.11596] 24L encoder + 24L decoder, d_model=1024, 16H (kv=16),
d_ff=8192, vocab=256206. The modality frontend (mel-spectrogram +
conformer feature extractor) is the mandated STUB: input_specs() provides
precomputed frame embeddings; we implement the transformer backbone with
cross-attention decode.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    num_layers=24,
    encoder_layers=24,
    cross_attention=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    source="arXiv:2308.11596",
    attention="gqa",
    mlp="gelu",
    norm="layernorm",
    modality="audio",
    frontend_tokens=1024,  # encoded audio frames per utterance
    max_seq_len=4096,
)
