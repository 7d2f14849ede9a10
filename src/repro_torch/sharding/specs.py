"""Sharding rules for parameters, activations, inputs and caches.

Sharding philosophy (the reference's, rule for rule):

* weights — Megatron tensor parallelism over the ``model`` axis: column-
  sharded up-projections (q/gate/up/w_x/w_z), row-sharded down-projections
  (o/down/w_out), vocab-sharded embeddings/head. MoE experts shard their
  leading E axis over ``model`` (expert parallelism).
* batch — over ``data`` (and ``pod`` when present): pure data parallelism;
  gradients are reduced over those axes.
* KV caches — batch over (pod, data); the sequence axis over ``model``
  (flash-decode style), which works for every kv-head count including
  gemma's MQA kv=1 and scales to long_500k.
* anything whose dim is not divisible by the axis size falls back to
  replication — the rule table never produces an invalid spec.

A spec is a plain tuple with one entry per tensor dimension — ``None``
(replicated), a mesh-axis name, or a tuple of names — the reference's
``PartitionSpec`` as a value; ``()`` replicates every dimension.  The
rule functions read only ``mesh.mesh_dim_names`` and ``mesh.shape``, so a
``DeviceMesh`` and a stand-in with those two attributes both work.
``placements`` turns a spec into DTensor placements, and
``make_shard_fn`` is the hook the model code calls on its activations.

All rules key on parameter-path *names*, so they apply equally to the
stacked (leading L axis) per-layer trees.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def P(*dims):
    """A partition spec: one entry per leading tensor dimension; as
    ``PartitionSpec`` reads them, a tuple of one axis is that axis and an
    empty tuple is None."""
    norm = lambda d: (d or None) if not isinstance(d, tuple) or len(d) != 1 else d[0]
    return tuple(norm(d) for d in dims)


# (path-suffix name) -> spec for the LAST n dims of the array.
# None entries replicate that dim; axis names shard it.
_PARAM_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings / head
    "table": ("model", None),  # (V, d) vocab-sharded
    "w|lm_head": (None, "model"),
    # attention
    "w_q": (None, "model"),
    "w_k": (None, "model"),
    "w_v": (None, "model"),
    "w_o": ("model", None),
    # MLA
    "w_dq": (None, "model"),
    "w_uq": (None, "model"),
    "w_dkv": (None, None),  # latent stays replicated (it is the cache)
    "w_uk": (None, "model"),
    "w_uv": (None, "model"),
    # MLP
    "w_gate|mlp": (None, "model"),
    "w_up|mlp": (None, "model"),
    "w_down|mlp": ("model", None),
    # MoE (leading E axis -> expert parallelism)
    "router": (None, None),
    "w_gate|moe": ("model", None, None),
    "w_up|moe": ("model", None, None),
    "w_down|moe": ("model", None, None),
    # SSM
    "w_z": (None, "model"),
    "w_x": (None, "model"),
    "w_bc": (None, None),
    "w_dt": (None, None),
    "conv_x_w": (None, "model"),
    "conv_x_b": ("model",),
    "conv_bc_w": (None, None),
    "conv_bc_b": (None,),
    "a_log": (None,),
    "dt_bias": (None,),
    "d_skip": (None,),
    "w_out": ("model", None),
}


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _map_with_path(fn, tree, names=()):
    """``fn(names, leaf)`` over a nested dict or NamedTuple (its ``None``
    fields kept), ``names`` the keys or field names down to the leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, names + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(None if v is None else _map_with_path(fn, v, names + (k,))
                            for k, v in zip(tree._fields, tree)))
    return fn(names, tree)


def _lookup_rule(names: Tuple[str, ...]) -> Optional[Tuple[Optional[str], ...]]:
    if not names:
        return None
    leaf = names[-1]
    context = set(names[:-1])
    # contextual rules first ("w_gate|moe" means leaf w_gate under a moe node)
    for key, rule in _PARAM_RULES.items():
        if "|" in key:
            leaf_name, ctx = key.split("|")
            if leaf == leaf_name and ctx in context:
                return rule
    return _PARAM_RULES.get(leaf)


def _respect_divisibility(
    spec: Tuple[Optional[str], ...], shape, axis_sizes: Dict[str, int]
) -> Tuple[Optional[str], ...]:
    out = []
    for dim, axis in zip(shape, spec):
        if axis is None:
            out.append(None)
        else:
            size = axis_sizes.get(axis, 1)
            out.append(axis if dim % size == 0 and dim >= size else None)
    return tuple(out)


def param_specs(params_tree: Any, mesh) -> Any:
    """Spec tree matching ``params_tree`` (tensors, meta tensors or
    ``TensorSpec``s)."""
    axis_sizes = _axis_sizes(mesh)

    model_size = axis_sizes.get("model", 1)

    def spec_for(names, leaf):
        shape = tuple(leaf.shape)
        rule = _lookup_rule(names)
        if rule is None or len(shape) < len(rule):
            return P()
        # leading dims beyond the rule (the stacked L/G axes) replicate
        lead = (None,) * (len(shape) - len(rule))
        tail = _respect_divisibility(rule, shape[len(lead):], axis_sizes)
        # MoE fallback: when num_experts does not divide the model axis
        # (mixtral: E=8 on 16-way model), expert parallelism over E is
        # impossible and the bare rule would replicate the experts.  Shard
        # the per-expert d_ff dimension instead (Megatron within expert):
        # w_gate/w_up (E, d, f) -> (None, None, "model");
        # w_down (E, f, d) -> (None, "model", None).
        if (
            "moe" in set(names[:-1])
            and names[-1] in ("w_gate", "w_up", "w_down")
            and tail[0] is None
        ):
            ff_axis = 2 if names[-1] in ("w_gate", "w_up") else 1
            if shape[len(lead) + ff_axis] % model_size == 0:
                t = [None, None, None]
                t[ff_axis] = "model"
                tail = tuple(t)
        full = lead + tail
        if all(a is None for a in full):
            return P()
        return P(*full)

    return _map_with_path(spec_for, params_tree)


# ---------------------------------------------------------------------------
# Activations / inputs / caches
# ---------------------------------------------------------------------------


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def zero1_specs(p_specs: Any, params_tree: Any, mesh) -> Any:
    """ZeRO-1 optimizer-moment sharding: each moment's first ``model``-
    free, data-divisible dimension goes over (pod, data).  The update is
    elementwise, so no extra collectives appear in the step; only the
    gradient reduction changes shape."""
    axis_sizes = _axis_sizes(mesh)
    baxes = batch_axes(mesh)
    total = int(np.prod([axis_sizes[a] for a in baxes])) if baxes else 1

    def upgrade(spec, leaf):
        dims = list(spec) + [None] * (len(leaf.shape) - len(spec))
        for i, (d, axis) in enumerate(zip(leaf.shape, dims)):
            if axis is None and d % total == 0 and d >= total:
                dims[i] = baxes
                return P(*dims)
        return spec

    def walk(specs, leaves):
        if isinstance(specs, dict):
            return {k: walk(v, leaves[k]) for k, v in specs.items()}
        return upgrade(specs, leaves)

    return walk(p_specs, params_tree)


def _div(n: int, axes: Tuple[str, ...], axis_sizes: Dict[str, int]) -> bool:
    total = int(np.prod([axis_sizes[a] for a in axes])) if axes else 1
    return axes != () and n % total == 0 and n >= total


def input_specs_tree(inputs_tree: Any, mesh) -> Any:
    """Shard the batch dim of every model input over (pod, data)."""
    axis_sizes = _axis_sizes(mesh)
    baxes = batch_axes(mesh)

    def spec_for(names, leaf):
        shape = tuple(leaf.shape)
        if names and names[-1] == "positions" and len(shape) == 3:
            # mrope (3, B, S)
            if _div(shape[1], baxes, axis_sizes):
                return P(None, baxes, None)
            return P()
        if not shape:
            return P()
        if _div(shape[0], baxes, axis_sizes):
            return P(*((baxes,) + (None,) * (len(shape) - 1)))
        return P()

    return _map_with_path(spec_for, inputs_tree)


def cache_specs(cache_tree: Any, mesh) -> Any:
    """Decode-cache sharding: batch over (pod, data); the cache sequence
    axis over ``model`` (flash-decode); SSM states shard their head axis
    when divisible."""
    axis_sizes = _axis_sizes(mesh)
    baxes = batch_axes(mesh)

    def spec_for(names, leaf):
        shape = tuple(leaf.shape)
        leafname = names[-1] if names else ""
        if leafname == "position":
            return P()
        dims: list = [None] * len(shape)
        if leafname in ("attn_k", "attn_v", "shared_k", "shared_v",
                        "cross_k", "cross_v", "local_k", "local_v"):
            # (L_or_G, B, T, KV, D)
            if _div(shape[1], baxes, axis_sizes):
                dims[1] = baxes
            if shape[2] % axis_sizes.get("model", 1) == 0:
                dims[2] = "model"
        elif leafname in ("mla_c", "mla_rope"):
            # (L, B, T, R)
            if _div(shape[1], baxes, axis_sizes):
                dims[1] = baxes
            if shape[2] % axis_sizes.get("model", 1) == 0:
                dims[2] = "model"
        elif leafname in ("ssm_conv_x",):
            # (L, B, w, d_inner)
            if _div(shape[1], baxes, axis_sizes):
                dims[1] = baxes
            if shape[3] % axis_sizes.get("model", 1) == 0:
                dims[3] = "model"
        elif leafname in ("ssm_conv_bc",):
            if _div(shape[1], baxes, axis_sizes):
                dims[1] = baxes
        elif leafname == "ssm_state":
            # (L, B, H, P, N)
            if _div(shape[1], baxes, axis_sizes):
                dims[1] = baxes
            if shape[2] % axis_sizes.get("model", 1) == 0:
                dims[2] = "model"
        else:
            if shape and _div(shape[0], baxes, axis_sizes):
                dims[0] = baxes
        if all(d is None for d in dims):
            return P()
        return P(*dims)

    return _map_with_path(spec_for, cache_tree)


# ---------------------------------------------------------------------------
# Specs as DTensor placements, and the shard hook injected into model code
# ---------------------------------------------------------------------------


def placements(spec: Tuple, mesh) -> Tuple:
    """A spec as DTensor placements on ``mesh``: ``Shard(i)`` on each mesh
    dimension that tensor dimension i names, ``Replicate()`` on the rest.
    A dimension named by several axes is split over them in the order
    given, major to minor, as a ``PartitionSpec`` splits it."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.mesh_dim_names]
    for i, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                out[mesh.mesh_dim_names.index(axis)] = Shard(i)
    return tuple(out)


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """Each tensor of ``tree`` as a DTensor on ``mesh``, placed by the
    matching spec of ``specs``: the local shard of a full tensor that
    every rank holds (``distribute_tensor`` keeps the shard, and sends
    rank 0's values, so the ranks must agree)."""
    from torch.distributed.tensor import distribute_tensor

    def walk(t, s):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(v, sv) for v, sv in zip(t, s)))
        return distribute_tensor(t, mesh, placements(s, mesh))

    return walk(tree, specs)


_ACTIVATION_RULES = {
    "activation": lambda b: P(b, None, None),
    "logits": lambda b: P(b, None, "model"),
    "decode_activation": lambda b: P(b, None, None),
    "decode_logits": lambda b: P(b, None, "model"),
    # MoE dispatch buffer (B, E, C, d): batch over (pod, data); experts
    # over model when divisible (expert parallelism) — checked at runtime
    # by make_shard_fn's divisibility guard.
    "moe_buf": lambda b: P(b, "model", None, None),
}


def activation_spec(shape, name: str, mesh) -> Optional[Tuple]:
    """The spec ``make_shard_fn`` gives an activation of ``shape`` under
    ``name``: the rule's axes that divide their dimension, or None where
    the hook leaves the tensor as it is (no rule, fewer than 2 dims, or
    nothing left to shard)."""
    axis_sizes = _axis_sizes(mesh)
    rule = _ACTIVATION_RULES.get(name)
    if rule is None or len(shape) < 2:
        return None
    dims = list(rule(batch_axes(mesh)))
    # strip axes that do not divide
    for i, axis in enumerate(dims):
        if axis is None:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        total = int(np.prod([axis_sizes.get(a, 1) for a in axes]))
        if i >= len(shape) or shape[i] % total != 0 or shape[i] < total:
            dims[i] = None
    dims = dims[: len(shape)] + [None] * max(0, len(shape) - len(dims))
    if all(d is None for d in dims):
        return None
    return P(*dims)


def make_shard_fn(mesh):
    """Returns shard(x, name): a DTensor ``x`` redistributed to its
    activation rule's placements on ``mesh`` (the reference's
    ``with_sharding_constraint``); divisibility-checked so batch-1 decode
    just replicates.  A plain tensor passes through: it is not on the
    mesh."""
    from torch.distributed.tensor import DTensor

    def shard(x, name):
        if not isinstance(x, DTensor):
            return x
        spec = activation_spec(tuple(x.shape), name, mesh)
        if spec is None:
            return x
        return x.redistribute(mesh, placements(spec, mesh))

    shard.mesh = mesh  # exposed for the MoE's expert-parallel combine
    return shard


def local_shape(shape, spec: Tuple, mesh) -> Tuple[int, ...]:
    """The shape of rank 0's shard of a tensor of ``shape`` under
    ``spec``: each dimension divided by the product of the axes that
    split it (the specs only split dimensions that the axes divide)."""
    axis_sizes = _axis_sizes(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                out[i] //= axis_sizes[axis]
    return tuple(out)


def local_nbytes(tree: Any, specs: Any, mesh) -> int:
    """Bytes of one device's shards of every tensor (or ``TensorSpec``)
    of ``tree`` under ``specs``."""
    total = 0

    def walk(t, s):
        nonlocal total
        if t is None:
            return
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, s[k])
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for v, sv in zip(t, s):
                walk(v, sv)
        else:
            n = int(np.prod(local_shape(tuple(t.shape), s, mesh), dtype=np.int64))
            total += n * torch.empty((), dtype=t.dtype).element_size()

    walk(tree, specs)
    return total
