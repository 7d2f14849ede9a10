"""Mixture-of-Experts: top-k router + two dispatch implementations.

* ``impl="dense"`` — every expert runs on every token, outputs combined
  by gate weights. Exact (no token dropping), FLOP-inflated by E/k; used
  by the reduced configs where E <= 4.

* ``impl="dropping"`` — GShard/Switch-style capacity-bounded dispatch,
  built with a stable sort + scatter per batch row. Tokens above an
  expert's capacity are dropped (their residual passes through).

The router breaks ties as ``jax.lax.top_k`` does (the lower expert index
first) and the sort is stable, as ``jnp.argsort(stable=True)``.  The
scatter-adds are ``index_put_(accumulate=True)`` / ``index_add_``: on the
CPU they sum duplicates in index order; on the card their order over
duplicates is not fixed, so results there agree to rounding.

Expert parallelism (the reference's ``shard_map`` combine over a mesh
whose ``model`` axis is larger than 1) is not ported: handed such a
mesh, ``moe_forward`` raises ``NotImplementedError``.

Router aux loss follows Switch Transformer: E * sum_e f_e * p_e, where
f_e is the fraction of tokens whose top-1 choice is e and p_e the mean
router probability of e.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models import layers


def init_moe(generator, cfg: ArchConfig, dtype=torch.float32, device="cuda") -> Dict:
    m = cfg.moe
    d = cfg.d_model
    w = lambda shape: layers._dense_init(generator, shape, dtype, device)
    return {
        "router": w((d, m.num_experts)),
        # experts stacked on a leading E axis
        "w_gate": w((m.num_experts, d, m.d_ff)),
        "w_up": w((m.num_experts, d, m.d_ff)),
        "w_down": w((m.num_experts, m.d_ff, d)),
    }


def _router(params, m: MoEConfig, x2d: torch.Tensor):
    """x2d (T, d) -> (gates (T, k), idx (T, k), aux_loss)."""
    logits = x2d.to(torch.float32) @ params["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    # top-k with the lower index first among equal probabilities
    ordered, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = ordered[:, : m.experts_per_token], order[:, : m.experts_per_token]
    gates = gates / torch.clamp(torch.sum(gates, dim=-1, keepdim=True), min=1e-9)
    # Switch-style load balance loss
    e = m.num_experts
    top1 = idx[:, 0]
    f = torch.mean(F.one_hot(top1, e).to(torch.float32), dim=0)
    p = torch.mean(probs, dim=0)
    aux = e * torch.sum(f * p)
    return gates, idx, aux


def _activation(h: torch.Tensor, kind: str) -> torch.Tensor:
    return F.silu(h) if kind == "swiglu" else layers.gelu(h)


def _model_axis_size(mesh) -> int:
    """The size of a device mesh's ``model`` axis (1 if it has none)."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    return dict(zip(names, tuple(mesh.shape))).get("model", 1)


def moe_forward(
    params: Dict,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, S, d)
    shard=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,d), aux_loss scalar). ``shard`` is the launcher's
    sharding hook (identity by default)."""
    if shard is None:
        shard = lambda t, name: t
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    gates, idx, aux = _router(params, m, x2d)

    if m.impl == "dense":
        # (E, T, d) all-experts compute, exact combine
        h = torch.einsum("td,edf->etf", x2d, params["w_gate"])
        up = torch.einsum("td,edf->etf", x2d, params["w_up"])
        y_all = torch.einsum("etf,efd->etd", _activation(h, cfg.mlp) * up,
                             params["w_down"])  # (E,T,d)
        combine = torch.zeros((t, m.num_experts), dtype=torch.float32, device=x.device)
        rows = torch.arange(t, device=x.device)[:, None].expand_as(idx)
        combine.index_put_((rows, idx), gates, accumulate=True)
        y = torch.einsum("te,etd->td", combine.to(x.dtype), y_all)
        return y.reshape(b, s, d), aux

    # ---- dropping dispatch (batch-local: sort and scatter per row) ----
    k = m.experts_per_token
    e = m.num_experts
    sk = s * k
    capacity = max(1, int(-(-sk * m.capacity_factor // e)))  # ceil, static

    idx_rows = idx.reshape(b, sk)
    gate_rows = gates.reshape(b, sk)
    bufs, meta = [], []
    for row in range(b):
        eid, gate = idx_rows[row], gate_rows[row]
        order = torch.sort(eid, stable=True).indices
        e_sorted = eid[order]
        tok_sorted = torch.div(order, k, rounding_mode="floor")
        gate_sorted = gate[order]
        counts = torch.bincount(e_sorted, minlength=e)
        starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
        pos = torch.arange(sk, device=x.device) - starts[e_sorted]
        keep = pos < capacity
        safe_pos = torch.where(keep, pos, torch.zeros_like(pos))
        rows = x[row][tok_sorted] * keep[:, None].to(x.dtype)
        buf = torch.zeros((e, capacity, d), dtype=x.dtype, device=x.device)
        buf.index_put_((e_sorted, safe_pos), rows, accumulate=True)
        bufs.append(buf)
        meta.append((e_sorted, safe_pos, keep, tok_sorted, gate_sorted))
    buf = shard(torch.stack(bufs), "moe_buf")  # (B, E, C, d)

    mesh = getattr(shard, "mesh", None)
    if mesh is not None:
        model_size = _model_axis_size(mesh)
        if model_size > 1 and e % model_size == 0:
            raise NotImplementedError(
                "expert-parallel MoE over a mesh's 'model' axis is not ported")

    gate_w = torch.einsum("becd,edf->becf", buf, params["w_gate"])
    up = torch.einsum("becd,edf->becf", buf, params["w_up"])
    y_buf = torch.einsum("becf,efd->becd", _activation(gate_w, cfg.mlp) * up,
                         params["w_down"])
    y_buf = shard(y_buf, "moe_buf")

    ys = []
    for row in range(b):
        e_sorted, safe_pos, keep, tok_sorted, gate_sorted = meta[row]
        rows = y_buf[row][e_sorted, safe_pos] * (
            gate_sorted * keep.to(torch.float32)).to(y_buf.dtype)[:, None]
        ys.append(torch.zeros((s, d), dtype=y_buf.dtype, device=x.device)
                  .index_add_(0, tok_sorted, rows))
    y = torch.stack(ys)  # (B, S, d)
    return shard(y, "activation"), aux
