"""Architecture configuration schema.

One ``ArchConfig`` instance per assigned architecture (see
``repro_torch.configs.<id>``). The schema spans six architecture families
(dense / MoE / SSM / hybrid / audio enc-dec / VLM); fields irrelevant to
a family stay at their zero defaults.

``reduced()`` produces the mandated smoke variant (<=2 layers,
d_model <= 512, <= 4 experts) used by the per-arch CPU tests; the full
configs run as shapes on the meta device, and gemma-2b's at full width
on the card (``chip_smoke.py``).  The code is the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

FULL_ATTENTION = 0  # sliding_window value meaning "no window"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention dims (DeepSeek-V2 style, as used by
    MiniCPM3): queries/keys factor through low-rank latents; RoPE is
    carried by decoupled per-head dims so the latent stays cacheable."""

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block hyperparameters."""

    d_state: int
    head_dim: int = 64
    n_groups: int = 1
    d_conv: int = 4
    chunk_size: int = 64
    expand: int = 2  # d_inner = expand * d_model


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    d_ff: int  # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance loss weight
    impl: str = "dropping"  # "dropping" (GShard-style) | "dense"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int  # 0 => attention-free
    num_kv_heads: int
    d_ff: int  # dense-MLP hidden dim (0 for pure-SSM / pure-MoE)
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads
    source: str = ""  # citation: arXiv id / model card

    # --- attention flavour ---
    attention: str = "gqa"  # gqa | mla | none
    rope_theta: float = 1e4
    sliding_window: int = FULL_ATTENTION  # applies to *windowed* layers
    # Layer-pattern period for mixed local/global attention. 0 = uniform.
    # gemma3: pattern period 6, one global layer per period (5:1).
    attn_pattern_period: int = 0
    global_layers_per_period: int = 0
    mrope: bool = False  # Qwen2-VL multimodal rotary (t/h/w sections)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    mla: Optional[MLAConfig] = None
    logit_softcap: float = 0.0  # gemma-style attn/final softcapping

    # --- MLP flavour ---
    mlp: str = "swiglu"  # swiglu | geglu | gelu
    # --- MoE ---
    moe: Optional[MoEConfig] = None
    # --- SSM / hybrid ---
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): a shared attention block applied every
    # ``shared_attn_every`` SSM layers, reusing ONE set of weights.
    shared_attn_every: int = 0

    # --- encoder-decoder (seamless) ---
    encoder_layers: int = 0
    cross_attention: bool = False

    # --- modality frontend (stub: embeddings arrive precomputed) ---
    modality: str = "text"  # text | audio | vision
    frontend_tokens: int = 0  # embeddings prepended per request

    # --- misc ---
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    scale_embeddings: bool = False  # multiply embeddings by sqrt(d_model)
    tie_embeddings: bool = False
    max_seq_len: int = 131072
    dtype: str = "bfloat16"

    # ---------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def is_decoder_only(self) -> bool:
        return self.encoder_layers == 0

    def supports_long_context(self) -> bool:
        """True iff attention cost per decoded token is sub-quadratic in
        context (SSM/hybrid state or a bounded attention window on all
        non-global layers). Pure full-attention archs return False and
        long_500k is skipped for them (DESIGN.md §Arch-applicability)."""
        if self.arch_type in ("ssm", "hybrid"):
            return True
        if self.sliding_window != FULL_ATTENTION:
            return True
        return False

    def layer_window_sizes(self) -> Tuple[int, ...]:
        """Per-layer attention window (0 = full/global), honoring the
        local:global pattern. For uniform archs this is constant."""
        if self.num_heads == 0:
            return ()
        n = self.num_layers
        if self.attn_pattern_period <= 0:
            return (self.sliding_window,) * n
        period = self.attn_pattern_period
        n_global = self.global_layers_per_period
        out = []
        for i in range(n):
            # the last `n_global` layers of each period are global
            is_global = (i % period) >= (period - n_global)
            out.append(FULL_ATTENTION if is_global else self.sliding_window)
        return tuple(out)

    def param_count(self) -> int:
        """Analytic parameter count N (embedding included once)."""
        d = self.d_model
        hd = self.resolved_head_dim
        n_attn = 0
        n_mlp = 0
        n_ssm = 0
        attn_layers = self.num_layers if self.num_heads else 0
        ssm_layers = 0
        if self.arch_type == "hybrid":
            ssm_layers = self.num_layers
            attn_layers = 1  # one shared block
        elif self.arch_type == "ssm":
            ssm_layers = self.num_layers
            attn_layers = 0
        if attn_layers:
            if self.mla is not None:
                m = self.mla
                per = (
                    d * m.q_lora_rank
                    + m.q_lora_rank
                    * self.num_heads
                    * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank
                    * self.num_heads
                    * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.num_heads * m.v_head_dim * d
                )
            else:
                per = (
                    d * self.num_heads * hd  # Q
                    + 2 * d * self.num_kv_heads * hd  # K, V
                    + self.num_heads * hd * d  # O
                )
            if self.cross_attention:
                per *= 2  # self + cross attention in decoder blocks
            n_attn = attn_layers * per
        if self.moe is not None:
            n_mlp = self.num_layers * (
                self.moe.num_experts * 3 * d * self.moe.d_ff
                + d * self.moe.num_experts  # router
            )
        elif self.d_ff:
            mults = 3 if self.mlp in ("swiglu", "geglu") else 2
            # hybrid: the MLP lives only in the single shared block
            mlp_layers = 1 if self.arch_type == "hybrid" else self.num_layers
            n_mlp = mlp_layers * mults * d * self.d_ff
        if self.ssm is not None:
            s = self.ssm
            d_inner = s.expand * d
            n_heads_ssm = d_inner // s.head_dim
            per = (
                d * (2 * d_inner + 2 * s.n_groups * s.d_state + n_heads_ssm)
                + (d_inner + 2 * s.n_groups * s.d_state) * s.d_conv
                + d_inner * d  # out proj
                + 2 * n_heads_ssm  # A, D
            )
            n_ssm = ssm_layers * per
        n_embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        n_enc = 0
        if self.encoder_layers:
            per_enc = 4 * d * d + 2 * d * self.d_ff
            n_enc = self.encoder_layers * per_enc
        n_norms = (self.num_layers * 2 + 1) * d
        return int(n_attn + n_mlp + n_ssm + n_embed + n_enc + n_norms)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k experts only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        moe_all = self.num_layers * self.moe.num_experts * 3 * self.d_model * self.moe.d_ff
        moe_active = (
            self.num_layers
            * self.moe.experts_per_token
            * 3
            * self.d_model
            * self.moe.d_ff
        )
        return int(full - moe_all + moe_active)

    # ---------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family, tiny dims."""
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4) if self.num_heads else 0
        kv = min(self.num_kv_heads, max(1, num_heads // 2)) if num_heads else 0
        changes = dict(
            name=self.name + "-reduced",
            num_layers=2,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=kv,
            head_dim=64 if num_heads else 0,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            encoder_layers=min(self.encoder_layers, 2),
            max_seq_len=512,
            attn_pattern_period=2 if self.attn_pattern_period else 0,
            global_layers_per_period=1 if self.attn_pattern_period else 0,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window
            else 0,
            shared_attn_every=2 if self.shared_attn_every else 0,
            frontend_tokens=min(self.frontend_tokens, 16),
            dtype="float32",
        )
        if self.mrope:
            # rescale the (t, h, w) frequency sections to the reduced
            # head_dim, preserving the 1:1.5:1.5 proportions
            half = 64 // 2
            scale = half / sum(self.mrope_sections)
            secs = [int(s * scale) for s in self.mrope_sections]
            secs[0] += half - sum(secs)
            changes["mrope_sections"] = tuple(secs)
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe,
                num_experts=4,
                experts_per_token=min(2, self.moe.experts_per_token),
                d_ff=128,
                impl="dense",
            )
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=32, chunk_size=32
            )
        if self.mla is not None:
            changes["mla"] = MLAConfig(
                q_lora_rank=64,
                kv_lora_rank=32,
                qk_nope_head_dim=32,
                qk_rope_head_dim=16,
                v_head_dim=32,
            )
        return dataclasses.replace(self, **changes)
