"""Shared neural-net building blocks (plain PyTorch, explicit param dicts).

Every module is a pair of functions: ``init_*(generator, ...) -> params``
and ``apply`` (here usually inlined at call sites). Params are plain
nested dicts of tensors with the reference's keys and shapes, so a
reference parameter tree carries across leaf for leaf
(``transformer.params_from_numpy``).

Semantics follow the reference, not PyTorch's defaults: GELU is the tanh
form, norms and rotary embeddings compute in float32 and cast back, and
``embed`` reads out-of-range ids as ``jnp.take`` does (NaN rows for ids
past the table, Python-style wrap for ids in [-vocab, -1]).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

DEFAULT_INIT_SCALE = 0.02


def _dense_init(generator: Optional[torch.Generator], shape, dtype, device,
                scale: Optional[float] = None) -> torch.Tensor:
    """N(0, scale^2) weights drawn from ``generator`` on its own device and
    moved to ``device``; on the meta device, shapes only."""
    scale = DEFAULT_INIT_SCALE if scale is None else scale
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return (w * scale).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, dtype=torch.float32, device="cuda"):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with (1 + scale) weighting (gemma convention; a zero-init
    scale is exactly standard RMSNorm at init)."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].to(torch.float32))).to(x.dtype)


def init_layernorm(d: int, dtype=torch.float32, device="cuda"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].to(torch.float32) + params["bias"].to(torch.float32)
    return y.to(x.dtype)


def init_norm(kind: str, d: int, dtype=torch.float32, device="cuda"):
    if kind == "rmsnorm":
        return init_rmsnorm(d, dtype, device)
    return init_layernorm(d, dtype, device)


def apply_norm(kind: str, params, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``: the tanh form."""
    return F.gelu(x, approximate="tanh")


def init_mlp(generator, d_model: int, d_ff: int, kind: str,
             dtype=torch.float32, device="cuda"):
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": _dense_init(generator, (d_model, d_ff), dtype, device),
            "w_up": _dense_init(generator, (d_model, d_ff), dtype, device),
            "w_down": _dense_init(generator, (d_ff, d_model), dtype, device),
        }
    return {
        "w_up": _dense_init(generator, (d_model, d_ff), dtype, device),
        "w_down": _dense_init(generator, (d_ff, d_model), dtype, device),
    }


def mlp(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        gate = F.silu(x @ params["w_gate"])
        return (gate * (x @ params["w_up"])) @ params["w_down"]
    if kind == "geglu":
        gate = gelu(x @ params["w_gate"])
        return (gate * (x @ params["w_up"])) @ params["w_down"]
    if kind == "gelu":
        return gelu(x @ params["w_up"]) @ params["w_down"]
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------


def init_embedding(generator, vocab: int, d: int, dtype=torch.float32,
                   device="cuda"):
    return {"table": _dense_init(generator, (vocab, d), dtype, device)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the table, as ``jnp.take(table, tokens, axis=0)`` reads them:
    ids in [-vocab, -1] wrap, ids outside [-vocab, vocab) give NaN rows."""
    table = params["table"]
    vocab = table.shape[0]
    idx = torch.where(tokens < 0, tokens + vocab, tokens)
    valid = (idx >= 0) & (idx < vocab)
    # F.embedding is table[ids]; on a DTensor it keeps the ids' batch
    # split against a vocab-split table (an indexing op would replicate)
    rows = F.embedding(idx.clamp(0, vocab - 1), table)
    return rows.masked_fill(~valid[..., None], float("nan"))


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Logits via the (possibly tied) embedding table."""
    return x @ params["table"].T


# ---------------------------------------------------------------------------
# Rotary position embeddings (NeoX half-split convention)
# ---------------------------------------------------------------------------


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """positions (...,) -> angles (..., head_dim//2) in f32."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=positions.device), exponent)
    return positions.to(torch.float32)[..., None] * inv_freq


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D); angles (..., S, D//2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1f, x2f = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    ang = angles[..., None, :]  # add head axis
    cos, sin = torch.cos(ang), torch.sin(ang)
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     dim=-1).to(x.dtype)


def mrope_angles(
    positions: torch.Tensor,  # (3, ..., S) — temporal / height / width
    head_dim: int,
    theta: float,
    sections: Sequence[int],
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the head_dim//2 frequency slots are
    partitioned into (t, h, w) sections; each section takes its angle from
    the corresponding position component. Text tokens pass identical
    components, which makes M-RoPE collapse to standard RoPE (Sec. 2.1 of
    arXiv:2409.12191)."""
    half = head_dim // 2
    assert sum(sections) == half, (sections, half)
    ang = rope_angles(positions, head_dim, theta)  # (3, ..., S, half)
    parts, start = [], 0
    for i, s in enumerate(sections):
        parts.append(ang[i, ..., start:start + s])
        start += s
    return torch.cat(parts, dim=-1)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma-style logit soft-capping; identity when cap == 0."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)
