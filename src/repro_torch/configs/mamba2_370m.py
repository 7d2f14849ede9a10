"""mamba2-370m — pure SSM (state-space duality / SSD).

[arXiv:2405.21060] 48L, d_model=1024, attention-free, vocab=50280,
ssm_state=128. d_inner = 2*d_model = 2048, head_dim 64 => 32 SSD heads.
Constant-size recurrent state: the paper's future-work wish (no growing
inter-step payload) realized — see DESIGN.md §Arch-applicability.
"""

from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    arch_type="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    source="arXiv:2405.21060",
    attention="none",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk_size=64),
    tie_embeddings=True,
    max_seq_len=1048576,
)
