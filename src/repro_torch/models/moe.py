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

On a device mesh (the inputs DTensors, ``shard`` the hook of
``sharding.specs.make_shard_fn``) the dispatch stays batch-local: each
rank sorts and scatters its own rows.  When the mesh's ``model`` axis is
larger than 1 and divides E, the reference's ``shard_map`` combine runs
as its explicit SPMD form: each ``model`` rank runs only its E/model
local experts on its slice of the (B, E, C, d) buffer, scatter-adds its
tokens' outputs, and the partial outputs are summed over ``model`` (a
``Partial`` DTensor made ``Replicate``: one all-reduce, the reference's
``psum``).  Otherwise the expert FFN runs on DTensors under the
parameters' placements.

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


# expert-parallel combines run (each a sum over 'model'): read by the dry
# run and chip_smoke.py to show which path a step took
combines = 0


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
    capacity = max(1, int(-(-s * k * m.capacity_factor // e)))  # ceil, static
    idx_rows = idx.reshape(b, s * k)
    gate_rows = gates.reshape(b, s * k)

    mesh = getattr(shard, "mesh", None)
    if mesh is not None and _is_dtensor(x):
        return _dropping_on_mesh(params, cfg, mesh, shard, x, idx_rows, gate_rows, capacity), aux
    if mesh is not None and 1 < _model_axis_size(mesh) and e % _model_axis_size(mesh) == 0:
        raise TypeError("expert parallelism over the mesh's 'model' axis takes the inputs as "
                        "DTensors on that mesh; got a plain tensor")

    buf, meta = _dispatch(x, idx_rows, gate_rows, e, k, capacity)
    buf = shard(buf, "moe_buf")  # (B, E, C, d)
    y_buf = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], buf, cfg.mlp)
    y_buf = shard(y_buf, "moe_buf")
    return shard(_combine(y_buf, meta, s, d), "activation"), aux


def _dispatch(x, idx_rows, gate_rows, e: int, k: int, capacity: int):
    """Each row's (S*k) assignments sorted by expert (stable) into a
    (B, E, C, d) buffer, and the per-row metadata the combine reads."""
    b, s, d = x.shape
    sk = s * k
    bufs, meta = [], []
    for row in range(b):
        eid, gate = idx_rows[row], gate_rows[row]
        order = torch.sort(eid, stable=True).indices
        e_sorted = eid[order]
        tok_sorted = torch.div(order, k, rounding_mode="floor")
        gate_sorted = gate[order]
        # bincount as a fixed-shape scatter (the dry run's meta tensors
        # cannot take a data-dependent output size)
        counts = torch.zeros(e, dtype=e_sorted.dtype, device=x.device).index_add_(
            0, e_sorted, torch.ones_like(e_sorted))
        starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
        pos = torch.arange(sk, device=x.device) - starts[e_sorted]
        keep = pos < capacity
        safe_pos = torch.where(keep, pos, torch.zeros_like(pos))
        rows = x[row][tok_sorted] * keep[:, None].to(x.dtype)
        buf = torch.zeros((e, capacity, d), dtype=x.dtype, device=x.device)
        buf.index_put_((e_sorted, safe_pos), rows, accumulate=True)
        bufs.append(buf)
        meta.append((e_sorted, safe_pos, keep, tok_sorted, gate_sorted))
    return torch.stack(bufs), meta


def _expert_ffn(w_gate, w_up, w_down, buf, kind: str):
    """(B, E, C, d) through per-expert gated MLPs -> (B, E, C, d)."""
    gate_w = torch.einsum("becd,edf->becf", buf, w_gate)
    up = torch.einsum("becd,edf->becf", buf, w_up)
    return torch.einsum("becf,efd->becd", _activation(gate_w, kind) * up, w_down)


def _combine(y_buf, meta, s: int, d: int, first_expert: int = 0):
    """Each row's token outputs: gate-weighted kept rows of ``y_buf``
    scatter-added back to their tokens.  ``y_buf`` holds experts
    [first_expert, first_expert + its E); assignments to other experts
    add nothing (the expert-parallel combine's local share)."""
    e_local = y_buf.shape[1]
    ys = []
    for row, (e_sorted, safe_pos, keep, tok_sorted, gate_sorted) in enumerate(meta):
        local_e = e_sorted - first_expert
        mine = (local_e >= 0) & (local_e < e_local) & keep
        le = torch.clamp(local_e, 0, e_local - 1)
        rows = y_buf[row][le, safe_pos] * (
            gate_sorted * mine.to(torch.float32)).to(y_buf.dtype)[:, None]
        ys.append(torch.zeros((s, d), dtype=y_buf.dtype, device=y_buf.device)
                  .index_add_(0, tok_sorted, rows))
    return torch.stack(ys)  # (B, S, d)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _dropping_on_mesh(params, cfg, mesh, shard, x, idx_rows, gate_rows, capacity):
    """The dropping MoE on DTensors: the dispatch and combine on each
    rank's own rows; the expert FFN expert-parallel when ``model`` > 1
    divides E, else on DTensors under the parameters' placements."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    b, s, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.experts_per_token
    names = mesh.mesh_dim_names
    # rows stay where the batch axes put them; everything else replicates
    rows_on = tuple(Shard(0) if n != "model" and p == Shard(0) else Replicate()
                    for n, p in zip(names, x.placements))
    local = lambda t: t.redistribute(mesh, rows_on).to_local()
    buf, meta = _dispatch(local(x), local(idx_rows), local(gate_rows), e, k, capacity)
    model_size = _model_axis_size(mesh)
    if model_size > 1 and e % model_size == 0:
        # expert-parallel: this model rank's experts only, then a sum over model
        global combines
        combines += 1
        e_local = e // model_size
        first = mesh.get_local_rank("model") * e_local
        expert_ps = _placements_of(mesh, {"model": Shard(0)})
        w = [params[n].redistribute(mesh, expert_ps).to_local()
             for n in ("w_gate", "w_up", "w_down")]
        y_buf = _expert_ffn(*w, buf[:, first:first + e_local], cfg.mlp)
        y_part = _combine(y_buf, meta, s, d, first_expert=first)
        partial = tuple(Partial() if n == "model" else p for n, p in zip(names, rows_on))
        y = DTensor.from_local(y_part, mesh, partial, shape=(b, s, d),
                               stride=(s * d, d, 1)).redistribute(mesh, rows_on)
        return shard(y, "activation")
    buf = shard(DTensor.from_local(buf, mesh, rows_on), "moe_buf")
    y_buf = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], buf, cfg.mlp)
    y_buf = shard(y_buf, "moe_buf")
    y = _combine(local(y_buf), meta, s, d)
    return shard(DTensor.from_local(y, mesh, rows_on, shape=(b, s, d),
                                    stride=(s * d, d, 1)), "activation")


def _placements_of(mesh, by_axis: Dict) -> Tuple:
    """Placements on ``mesh``: ``by_axis``'s for the axes it names,
    ``Replicate()`` for the rest."""
    from torch.distributed.tensor import Replicate

    return tuple(by_axis.get(n, Replicate()) for n in mesh.mesh_dim_names)
