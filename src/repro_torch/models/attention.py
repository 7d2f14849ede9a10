"""Attention: GQA/MQA, sliding windows, MLA, cross-attention, KV caches.

Three execution paths, as in the reference:

* ``attend_chunked`` — train/prefill. Memory-bounded online-softmax
  attention: a loop over query chunks with an inner loop over KV chunks
  carrying (max, denom, acc) in float32. Never materializes an (S, S)
  score matrix. It keeps the reference's chunk sizes, its finite
  ``NEG_INF`` and its pad positions, so a fully masked first chunk is
  washed out by the next one's ``alpha = 0`` instead of turning to NaN;
  no library attention stands in for it.
* ``attend_decode`` — one query against a full cache; linear in cache
  length.
* MLA (MiniCPM3) — latent-compressed KV. Prefill materializes k/v from
  the latent; decode uses the *absorbed* form (W_uk folded into the
  query, W_uv folded into the output) so the cache holds only the latent
  plus the decoupled RoPE key per token.

Cache writes follow ``jax.lax.dynamic_update_slice``: a write index past
the end is clamped to the last slot, never wrapped and never refused (a
negative one counts from the end once, then is clamped the same way).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers

NEG_INF = -2.0e38

# Cast softmax probabilities to bf16 before the PV product (float32
# accumulation kept), as the reference does under REPRO_BF16_ATTN=1.
BF16_PROBS = os.environ.get("REPRO_BF16_ATTN") == "1"


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def init_attention(generator, cfg: ArchConfig, dtype=torch.float32,
                   device="cuda") -> Dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    w = lambda shape: layers._dense_init(generator, shape, dtype, device)
    if cfg.attention == "mla":
        m = cfg.mla
        qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {
            "w_dq": w((d, m.q_lora_rank)),
            "q_norm": layers.init_rmsnorm(m.q_lora_rank, dtype, device),
            "w_uq": w((m.q_lora_rank, h * qk_head)),
            "w_dkv": w((d, m.kv_lora_rank + m.qk_rope_head_dim)),
            "kv_norm": layers.init_rmsnorm(m.kv_lora_rank, dtype, device),
            "w_uk": w((m.kv_lora_rank, h * m.qk_nope_head_dim)),
            "w_uv": w((m.kv_lora_rank, h * m.v_head_dim)),
            "w_o": w((h * m.v_head_dim, d)),
        }
    return {
        "w_q": w((d, h * hd)),
        "w_k": w((d, kv * hd)),
        "w_v": w((d, kv * hd)),
        "w_o": w((h * hd, d)),
    }


def init_cross_attention(generator, cfg: ArchConfig, dtype=torch.float32,
                         device="cuda") -> Dict:
    return init_attention(generator, cfg, dtype, device)


# ---------------------------------------------------------------------------
# Chunked (flash-style) attention — train/prefill
# ---------------------------------------------------------------------------


def _window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
                 causal: bool) -> torch.Tensor:
    """(Q, K) boolean mask. window: 0 => no window."""
    q = q_pos[:, None]
    k = k_pos[None, :]
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k <= q
    if int(window) != 0:
        mask &= q - k < int(window)
    return mask


def pad_axis1(x: torch.Tensor, n: int) -> torch.Tensor:
    """x zero-padded at the end of axis 1 by n (x itself when n is 0).
    Written as a concatenation: torch 2.11's DTensor pads a DTensor into
    one of the wrong shape and placements."""
    if n == 0:
        return x
    return torch.cat([x, zeros_axis1(x, n)], dim=1)


def zeros_axis1(x: torch.Tensor, n: int) -> torch.Tensor:
    """n zero rows along axis 1, shaped and placed as x's rows (a slice of
    a DTensor keeps its placements, so joining them moves no data)."""
    return torch.zeros_like(x.narrow(1, 0, 1)).expand(*x.shape[:1], n, *x.shape[2:])


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, KV, G, Q, K) x (B, K, KV, Dv) -> (B, KV, G, Q, Dv) in float32."""
    if BF16_PROBS:
        p = p.to(torch.bfloat16).to(torch.float32)
        v = v.to(torch.bfloat16)
    return torch.einsum("bhgqk,bkhd->bhgqd", p, v.to(torch.float32))


def attend_chunked(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, KV, D)
    v: torch.Tensor,  # (B, T, KV, Dv)
    *,
    q_positions: torch.Tensor,  # (S,)
    k_positions: torch.Tensor,  # (T,)
    window=0,
    causal: bool = True,
    q_chunk: int = 512,
    k_chunk: int = 1024,
    softcap_val: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention, O(q_chunk * k_chunk) live score memory.
    Supports distinct k and v head dims (MLA).

    DTensor q, k, v placed alike and split over batch and heads only (the
    sharding rules' placement) run the loops on each rank's local shards,
    as the reference's per-device program does, and come back as a
    DTensor placed like q: every op stays local, so none of the loops'
    ops pays DTensor's dispatch."""
    local = _local_heads(q, k, v)
    if local is not None:
        from torch.distributed.tensor import DTensor

        mesh, placements, (q, k, v) = local
        out = attend_chunked(
            q, k, v, q_positions=_full(q_positions), k_positions=_full(k_positions),
            window=window, causal=causal, q_chunk=q_chunk, k_chunk=k_chunk,
            softcap_val=softcap_val, scale=scale)
        # the shards split evenly (the reshapes into heads did), so the
        # global shape is the local one times the split
        return DTensor.from_local(out, mesh, placements, run_check=False)
    b, s, h, d = q.shape
    t = k.shape[1]
    kvh = k.shape[2]
    dv = v.shape[3]
    assert h % kvh == 0
    groups = h // kvh
    scale = (d ** -0.5) if scale is None else scale

    q_chunk = min(q_chunk, s)
    k_chunk = min(k_chunk, t)
    # pad S/T to chunk multiples
    s_pad = -(-s // q_chunk) * q_chunk
    t_pad = -(-t // k_chunk) * k_chunk
    qp = pad_axis1(q, s_pad - s)
    kp = pad_axis1(k, t_pad - t)
    vp = pad_axis1(v, t_pad - t)
    dev = q.device
    qpos = torch.cat([q_positions.to(torch.int32),
                      torch.full((s_pad - s,), -1, dtype=torch.int32, device=dev)])
    kpos = torch.cat([k_positions.to(torch.int32),
                      torch.full((t_pad - t,), 2**30, dtype=torch.int32, device=dev)])

    outs = []
    for qi in range(s_pad // q_chunk):
        qs = slice(qi * q_chunk, (qi + 1) * q_chunk)
        qg = qp[:, qs].reshape(b, q_chunk, kvh, groups, d).to(torch.float32)
        m = torch.full((b, h, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        denom = torch.zeros((b, h, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, q_chunk, dv), dtype=torch.float32, device=dev)
        for ki in range(t_pad // k_chunk):
            ks = slice(ki * k_chunk, (ki + 1) * k_chunk)
            # scores: (B, KV, G, Qc, Kc) via GQA head grouping
            scores = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                                  kp[:, ks].to(torch.float32)) * scale
            scores = layers.softcap(scores, softcap_val)
            mask = _window_mask(qpos[qs], kpos[ks], window, causal)
            scores = torch.where(mask[None, None, None], scores,
                                 torch.tensor(NEG_INF, dtype=torch.float32, device=dev))
            m_new = torch.maximum(m, torch.amax(scores, dim=-1).reshape(b, h, q_chunk))
            alpha = torch.exp(m - m_new)
            p = torch.exp(scores - m_new.reshape(b, kvh, groups, q_chunk)[..., None])
            denom = denom * alpha + torch.sum(p, dim=-1).reshape(b, h, q_chunk)
            pv = _pv(p, vp[:, ks]).reshape(b, h, q_chunk, dv)
            acc = acc * alpha[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp(denom[..., None], min=1e-30))  # (B, H, Qc, Dv)
    # (B, H, S_pad, Dv) -> (B, S, H, Dv)
    out = torch.cat(outs, dim=2).transpose(1, 2)[:, :s]
    return out.to(q.dtype)


def _local_heads(q, k, v):
    """(mesh, placements, local q, k, v) when q, k and v are DTensors
    placed alike, split over batch (dim 0) and heads (dim 2) only, with as
    many query heads a kv head on each shard as in all; else None."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(q, DTensor):
        return None
    placements = q.placements
    if not (isinstance(k, DTensor) and isinstance(v, DTensor)
            and k.placements == v.placements == placements
            and all(p == Replicate() or (isinstance(p, Shard) and p.dim in (0, 2))
                    for p in placements)):
        return None
    lq, lk, lv = q.to_local(), k.to_local(), v.to_local()
    if lq.shape[2] * k.shape[2] != lk.shape[2] * q.shape[2]:
        return None
    return q.device_mesh, placements, (lq, lk, lv)


def _full(t):
    """A DTensor's whole value (positions are replicated); a tensor as is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


# ---------------------------------------------------------------------------
# Decode attention — one token vs. cache
# ---------------------------------------------------------------------------


def _softmax_pv(scores: torch.Tensor, valid: torch.Tensor, v_cache: torch.Tensor):
    """Masked softmax over the cache axis and the weighted sum of V:
    scores (B, KV, G, T), valid (B, T) -> (B, KV, G, D) in float32."""
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=scores.device)
    scores = torch.where(valid[:, None, None, :], scores, neg)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgk,bkhd->bhgd", p, v_cache.to(torch.float32))


def attend_decode(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, T, KV, D)
    v_cache: torch.Tensor,  # (B, T, KV, D)
    *,
    position: torch.Tensor,  # (B,) current position (cache index just written)
    window=0,
    softcap_val: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    b, _, h, d = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    groups = h // kvh
    scale = (d ** -0.5) if scale is None else scale

    qg = q.reshape(b, kvh, groups, d)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg.to(torch.float32),
                          k_cache.to(torch.float32)) * scale
    scores = layers.softcap(scores, softcap_val)
    kpos = torch.arange(t, dtype=torch.int32, device=q.device)[None, :]  # (1, T)
    pos = position.to(torch.int32)[:, None]
    valid = kpos <= pos
    if int(window) != 0:
        valid &= pos - kpos < int(window)
    out = _softmax_pv(scores, valid, v_cache)
    return out.reshape(b, 1, h, d).to(q.dtype)


def attend_decode_ring(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, T, KV, D) ring buffer, T == window
    v_cache: torch.Tensor,
    *,
    position: torch.Tensor,  # (B,) absolute position just written
    softcap_val: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention over a ring buffer: every stored entry is inside
    the window by construction; mask only unwritten warm-up slots."""
    b, _, h, d = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    groups = h // kvh
    scale = (d ** -0.5) if scale is None else scale
    qg = q.reshape(b, kvh, groups, d)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg.to(torch.float32),
                          k_cache.to(torch.float32)) * scale
    scores = layers.softcap(scores, softcap_val)
    slots = torch.arange(t, dtype=torch.int32, device=q.device)[None, :]
    pos = position.to(torch.int32)[:, None]
    written = (slots <= pos) | (pos >= t)
    out = _softmax_pv(scores, written, v_cache)
    return out.reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Full GQA block apply (projections + rope + attention)
# ---------------------------------------------------------------------------


def gqa_forward(
    params: Dict,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, S, d_model)
    positions: torch.Tensor,  # (S,) or mrope (3, B, S)
    window=0,
    causal: bool = True,
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Train/prefill attention. kv_override supplies encoder memory for
    cross-attention (positions then index the memory)."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ params["w_q"]).reshape(b, s, h, hd)
    if kv_override is None:
        k = (x @ params["w_k"]).reshape(b, s, kvh, hd)
        v = (x @ params["w_v"]).reshape(b, s, kvh, hd)
        if cfg.mrope:
            ang = layers.mrope_angles(
                positions, hd, cfg.rope_theta, cfg.mrope_sections
            )  # (B, S, hd//2)
            q = layers.apply_rope(q, ang)
            k = layers.apply_rope(k, ang)
            qpos = positions[0, 0] if positions.ndim == 3 else positions
        else:
            ang = layers.rope_angles(positions, hd, cfg.rope_theta)
            q = layers.apply_rope(q, ang)
            k = layers.apply_rope(k, ang)
            qpos = positions
        kpos = qpos
    else:
        mem = kv_override[0]
        t = mem.shape[1]
        k = (mem @ params["w_k"]).reshape(b, t, kvh, hd)
        v = (mem @ params["w_v"]).reshape(b, t, kvh, hd)
        qpos = positions
        kpos = torch.arange(t, dtype=torch.int32, device=x.device)
        causal = False
    out = attend_chunked(
        q, k, v,
        q_positions=qpos,
        k_positions=kpos,
        window=window,
        causal=causal,
        softcap_val=cfg.logit_softcap,
    )
    return out.reshape(b, s, h * hd) @ params["w_o"]


def gqa_prefill_kv(
    params: Dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V to store in the cache during prefill (rope already applied)."""
    b, s, _ = x.shape
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    k = (x @ params["w_k"]).reshape(b, s, kvh, hd)
    v = (x @ params["w_v"]).reshape(b, s, kvh, hd)
    if cfg.mrope:
        ang = layers.mrope_angles(positions, hd, cfg.rope_theta, cfg.mrope_sections)
    else:
        ang = layers.rope_angles(positions, hd, cfg.rope_theta)
    return layers.apply_rope(k, ang), v


def gqa_decode(
    params: Dict,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, 1, d_model)
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    position: torch.Tensor,  # rope position: (B,) or mrope (3, B, 1)
    window=0,
    cache_pos: Optional[torch.Tensor] = None,  # (B,) cache write index
    ring: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step. Returns (out, new_k_cache, new_v_cache).

    ``position`` drives the rotary embedding; ``cache_pos`` is the slot
    the new KV is written to and the causal/window horizon. They differ
    for M-RoPE (image patches share a temporal position but occupy
    distinct cache slots); for text decode they coincide."""
    b = x.shape[0]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ params["w_q"]).reshape(b, 1, h, hd)
    k = (x @ params["w_k"]).reshape(b, 1, kvh, hd)
    v = (x @ params["w_v"]).reshape(b, 1, kvh, hd)
    if cfg.mrope:
        ang = layers.mrope_angles(
            position, hd, cfg.rope_theta, cfg.mrope_sections
        )  # (B, 1, hd//2)
        pos_scalar = position[0, :, 0] if cache_pos is None else cache_pos
    else:
        ang = layers.rope_angles(position[:, None], hd, cfg.rope_theta)
        pos_scalar = position if cache_pos is None else cache_pos
    q = layers.apply_rope(q, ang)
    k = layers.apply_rope(k, ang)
    if ring:
        # Ring-buffer cache for sliding-window layers: the cache holds
        # exactly the last T positions (T == window); contents are
        # within-window by construction, so the only mask needed is the
        # warm-up one (slots not yet written).
        t_ring = k_cache.shape[1]
        slot = pos_scalar % t_ring
        k_cache = _cache_write(k_cache, k[:, 0], slot)
        v_cache = _cache_write(v_cache, v[:, 0], slot)
        out = attend_decode_ring(
            q, k_cache, v_cache,
            position=pos_scalar,
            softcap_val=cfg.logit_softcap,
        )
    else:
        k_cache = _cache_write(k_cache, k[:, 0], pos_scalar)
        v_cache = _cache_write(v_cache, v[:, 0], pos_scalar)
        out = attend_decode(
            q, k_cache, v_cache,
            position=pos_scalar,
            window=window,
            softcap_val=cfg.logit_softcap,
        )
    return out.reshape(b, 1, h * hd) @ params["w_o"], k_cache, v_cache


def _cache_write(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor):
    """cache (B, T, ...) <- new (B, ...) at per-batch positions (B,), each
    read as ``dynamic_update_slice`` reads its start: a negative one counts
    from the end, then it is clamped into [0, T-1].  Returns a new tensor;
    ``cache`` is left as it was."""
    t = cache.shape[1]
    idx = pos.to(torch.long)
    idx = torch.where(idx < 0, idx + t, idx).clamp(0, t - 1)
    rows = torch.arange(cache.shape[0], device=cache.device)
    return cache.index_put((rows, idx), new.to(cache.dtype))


def gqa_cross_decode(
    params: Dict,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, 1, d)
    mem_k: torch.Tensor,  # precomputed encoder K (B, T, KV, D)
    mem_v: torch.Tensor,
) -> torch.Tensor:
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    q = (x @ params["w_q"]).reshape(b, 1, h, hd)
    t = mem_k.shape[1]
    out = attend_decode(
        q, mem_k, mem_v,
        position=torch.full((b,), t - 1, dtype=torch.int32, device=x.device),
        window=0,
        softcap_val=cfg.logit_softcap,
    )
    return out.reshape(b, 1, h * hd) @ params["w_o"]


# ---------------------------------------------------------------------------
# MLA (Multi-head Latent Attention) — MiniCPM3
# ---------------------------------------------------------------------------


def mla_forward(
    params: Dict,
    cfg: ArchConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """Train/prefill MLA: materialize per-head k/v from the latent."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim

    q_lat = layers.rmsnorm(params["q_norm"], x @ params["w_dq"])
    q = (q_lat @ params["w_uq"]).reshape(b, s, h, qk_head)
    q_nope, q_rope = q[..., : m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]

    dkv = x @ params["w_dkv"]  # (B, S, kv_lora + rope)
    c_kv = layers.rmsnorm(params["kv_norm"], dkv[..., : m.kv_lora_rank])
    k_rope = dkv[..., m.kv_lora_rank:][:, :, None]  # (B, S, 1, rope_dim)

    ang = layers.rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    q_rope = layers.apply_rope(q_rope, ang)
    k_rope = layers.apply_rope(k_rope, ang)

    k_nope = (c_kv @ params["w_uk"]).reshape(b, s, h, m.qk_nope_head_dim)
    v = (c_kv @ params["w_uv"]).reshape(b, s, h, m.v_head_dim)

    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat(
        [k_nope, k_rope.expand(k_nope.shape[:-1] + (m.qk_rope_head_dim,))], dim=-1
    )
    out = attend_chunked(
        q_full, k_full, v,
        q_positions=positions,
        k_positions=positions,
        window=0,
        causal=True,
        scale=qk_head ** -0.5,
    )
    return out.reshape(b, s, h * m.v_head_dim) @ params["w_o"]


def mla_prefill_cache(
    params: Dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Latent cache entries: (c_kv (B,S,R), k_rope (B,S,rope))."""
    m = cfg.mla
    dkv = x @ params["w_dkv"]
    c_kv = layers.rmsnorm(params["kv_norm"], dkv[..., : m.kv_lora_rank])
    k_rope = dkv[..., m.kv_lora_rank:][:, :, None]
    ang = layers.rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    return c_kv, layers.apply_rope(k_rope, ang)[:, :, 0]


def mla_decode(
    params: Dict,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, 1, d)
    c_cache: torch.Tensor,  # (B, T, R) latent cache
    rope_cache: torch.Tensor,  # (B, T, rope_dim)
    position: torch.Tensor,  # (B,)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed-form decode: scores = q_nope W_uk^T . c  +  q_rope . k_rope.

    The cache stores ONLY (c_kv, k_rope): kv_lora_rank + qk_rope_head_dim
    floats a token, against 2 * kv_heads * head_dim for the equivalent
    GQA cache."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    f32 = torch.float32

    q_lat = layers.rmsnorm(params["q_norm"], x @ params["w_dq"])
    q = (q_lat @ params["w_uq"]).reshape(b, 1, h, qk_head)
    q_nope, q_rope = q[..., : m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    ang = layers.rope_angles(position[:, None], m.qk_rope_head_dim, cfg.rope_theta)
    q_rope = layers.apply_rope(q_rope, ang)[:, 0]  # (B, H, rope)

    dkv = x @ params["w_dkv"]
    c_new = layers.rmsnorm(params["kv_norm"], dkv[..., : m.kv_lora_rank])[:, 0]
    k_rope_new = layers.apply_rope(dkv[..., m.kv_lora_rank:][:, :, None], ang)[:, 0, 0]
    c_cache = _cache_write(c_cache, c_new, position)
    rope_cache = _cache_write(rope_cache, k_rope_new, position)

    # absorb W_uk into q: (B, H, nope) @ (R, H, nope)^T -> (B, H, R)
    w_uk = params["w_uk"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].to(f32), w_uk.to(f32))
    scores = torch.einsum("bhr,btr->bht", q_abs, c_cache.to(f32))
    scores = scores + torch.einsum("bhp,btp->bht", q_rope.to(f32), rope_cache.to(f32))
    scores = scores * qk_head ** -0.5
    t = c_cache.shape[1]
    valid = torch.arange(t, device=x.device)[None] <= position[:, None]
    scores = torch.where(valid[:, None], scores,
                         torch.tensor(NEG_INF, dtype=f32, device=x.device))
    p = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bht,btr->bhr", p, c_cache.to(f32))
    # absorb W_uv on the way out: (B, H, R) x (R, H, v) -> (B, H, v)
    w_uv = params["w_uv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    o = torch.einsum("bhr,rhv->bhv", o_lat, w_uv.to(f32))
    out = o.reshape(b, 1, h * m.v_head_dim).to(x.dtype) @ params["w_o"]
    return out, c_cache, rope_cache
