"""Multi-pod dry run: one step of every (arch x shape x mesh) combo on a
fake process group.

The reference lowers and compiles each step under 512 placeholder XLA
devices.  The port's counterpart starts a *fake* process group of 256 or
512 ranks in its own process (``torch.testing``'s ``fake`` backend: every
collective returns at once, moving nothing) and runs the step as rank 0
would, its shards on the meta device (shapes and dtypes, no storage), so
no array is ever materialized.  For each combination this script:
  1. builds the step function (train_step / prefill / serve_step per the
     shape's kind) with the sharding rules of sharding/specs.py: every
     argument a DTensor on the production mesh, placed by its spec, and
     the model's activations redistributed by ``make_shard_fn``;
  2. runs it once under the op census (roofline/op_cost.py), which counts
     the ops rank 0 runs on its local shards and the collectives between
     them;
  3. records the per-device memory (the arguments' local shards plus the
     step's peak of live local bytes), the counted FLOPs and bytes, the
     collective census and the roofline terms (roofline/analysis.py);
  4. writes one JSON per combo under experiments/dryrun_torch/ (resumable),
     in the reference's record schema: ``lower_s`` is the time to build
     the step and its fake arguments, ``compile_s`` the time of the fake
     run (host seconds, both); ``hlo_bytes_len`` is None (there is no
     HLO); ``notes`` is the port's own key.

An op that DTensor has no sharding rule for runs on its inputs
redistributed to ``Replicate`` (an all-gather, which the census counts);
each such op is named in the record's ``notes`` (``fallbacks``), beside
the number of expert-parallel MoE combines the step ran.  The model's math never
changes.  ``REPRO_ZERO1=1`` shards the AdamW moments over the data axes,
``REPRO_RING=1`` gives sliding-window layers ring-buffer caches, as in
the reference.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--mesh single|multi|both] [--out DIR] [--force]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, List

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from repro_torch.configs import registry, shapes as shp
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import make_production_mesh, mesh_device_count
from repro_torch.models import moe, transformer
from repro_torch.optim import adamw
from repro_torch.roofline import analysis, op_cost
from repro_torch.sharding import specs as sspecs


def start_fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks in this process, this
    process rank 0 (a group of another size is replaced)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _fake_args(tree: Any, specs: Any, mesh) -> Any:
    """Each leaf of ``tree`` (a meta tensor or ``TensorSpec``) as a DTensor
    on ``mesh`` placed by its spec, its local shard a meta tensor (shape
    and dtype, no storage) of the shard's shape."""
    from torch.distributed.tensor import DTensor

    def make(leaf, spec):
        shape = tuple(leaf.shape)
        local = torch.empty(sspecs.local_shape(shape, spec, mesh), dtype=leaf.dtype,
                            device="meta")
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, mesh, sspecs.placements(spec, mesh),
                                  run_check=False, shape=shape, stride=stride)

    def walk(t, s):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(v, sv) for v, sv in zip(t, s)))
        return make(t, s)

    return walk(tree, specs)


def build_train(cfg: ArchConfig, shape, mesh):
    opt_cfg = adamw.AdamWConfig()
    shard = sspecs.make_shard_fn(mesh)

    def train_step(params, opt_state, batch):
        live = transformer.tree_map(lambda t: t.detach().requires_grad_(), params)
        leaves = [t for _, t in transformer.tree_leaves(live)]
        with torch.enable_grad():
            loss, metrics = transformer.loss_fn(cfg, live, batch, shard=shard, remat=True)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        by_leaf = dict(zip(map(id, leaves), grads))
        grads = transformer.tree_map(lambda t: by_leaf[id(t)], live)
        new_params, new_opt, opt_metrics = adamw.update(opt_cfg, grads, opt_state, params)
        metrics = dict(metrics, loss=loss.detach(), **opt_metrics)
        return new_params, new_opt, metrics

    params_sds = transformer.param_shapes(cfg)
    batch_sds = shp.token_inputs(cfg, shape)

    p_specs = sspecs.param_specs(params_sds, mesh)
    # REPRO_ZERO1=1 shards AdamW moments over the data axes (ZeRO-1):
    # replicated f32 moments otherwise dominate HBM.
    if os.environ.get("REPRO_ZERO1") == "1":
        m_specs = sspecs.zero1_specs(p_specs, params_sds, mesh)
    else:
        m_specs = p_specs
    params = _fake_args(params_sds, p_specs, mesh)
    opt_sds = adamw.init(params_sds)
    opt_state = adamw.AdamWState(
        step=_fake_args(opt_sds.step, (), mesh),
        mu=_fake_args(opt_sds.mu, m_specs, mesh),
        nu=_fake_args(opt_sds.nu, m_specs, mesh),
    )
    batch = _fake_args(batch_sds, sspecs.input_specs_tree(batch_sds, mesh), mesh)
    return train_step, (params, opt_state, batch)


def build_prefill(cfg: ArchConfig, shape, mesh):
    shard = sspecs.make_shard_fn(mesh)
    batch_sds = shp.token_inputs(cfg, shape)
    max_len = shape.seq_len
    if cfg.modality == "vision":
        # the vision frontend prepends patch embeddings to the stream
        max_len += cfg.frontend_tokens

    def prefill_step(params, batch):
        logits, cache = transformer.prefill(
            cfg,
            params,
            batch["tokens"],
            max_len=max_len,
            positions=batch.get("positions"),
            frontend_embeds=batch.get("frontend_embeds"),
            encoder_tokens=batch.get("encoder_tokens"),
            shard=shard,
        )
        return logits, cache

    params_sds = transformer.param_shapes(cfg)
    params = _fake_args(params_sds, sspecs.param_specs(params_sds, mesh), mesh)
    batch = _fake_args(batch_sds, sspecs.input_specs_tree(batch_sds, mesh), mesh)
    return prefill_step, (params, batch)


def build_decode(cfg: ArchConfig, shape, mesh):
    shard = sspecs.make_shard_fn(mesh)
    b = shape.global_batch
    max_len = shape.seq_len
    # REPRO_RING=1 switches sliding-window layers to ring-buffer caches of
    # length `window`.
    ring = (
        os.environ.get("REPRO_RING") == "1"
        and cfg.num_heads > 0
        and any(w > 0 for w in cfg.layer_window_sizes())
    )

    def serve_step(params, cache, batch):
        return transformer.decode_step(
            cfg,
            params,
            cache,
            batch["tokens"],
            positions=batch.get("positions") if cfg.mrope else None,
            shard=shard,
        )

    params_sds = transformer.param_shapes(cfg)
    cache_sds = transformer.cache_shapes(cfg, b, max_len, ring=ring)
    batch_all = shp.token_inputs(cfg, shape)
    batch_sds = {"tokens": batch_all["tokens"]}
    if cfg.mrope:
        batch_sds["positions"] = batch_all["positions"]

    params = _fake_args(params_sds, sspecs.param_specs(params_sds, mesh), mesh)
    cache = _fake_args(cache_sds, sspecs.cache_specs(cache_sds, mesh), mesh)
    batch = _fake_args(batch_sds, sspecs.input_specs_tree(batch_sds, mesh), mesh)
    return serve_step, (params, cache, batch)


def _tensors(tree) -> List[torch.Tensor]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def local_bytes(tree) -> int:
    """Bytes of this rank's local shards of every DTensor in ``tree``."""
    total = 0
    for t in _tensors(tree):
        local = t.to_local() if hasattr(t, "to_local") else t
        total += local.numel() * local.element_size()
    return total


class DryRunCounter(op_cost.OpCounter):
    """The op census, and a fallback for the ops DTensor cannot shard.

    An op on DTensors runs with the census re-entered, so DTensor's local
    ops and collectives come back to it; when its sharding propagation
    fails (no sharding rule, an uneven split, a plain tensor written with
    a DTensor), it runs again on its DTensor inputs redistributed to
    ``Replicate`` over the ``model`` axis (an all-gather there; the batch
    stays split), else over every mesh axis, else on the full replicas'
    local tensors (plain tensors).  It works below autograd, so the
    backward pass and remat's recomputation take the same path.  Each such
    op is named in ``notes``; an op that fails all three ways raises its
    first error."""

    def __init__(self):
        super().__init__()
        self.notes: Dict[str, int] = {}
        self._in_dtensor = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if self._in_dtensor or not any(isinstance(a, DTensor)
                                       for a in op_cost.tensors_in(args, kwargs)):
            return super().__torch_dispatch__(func, types, args, kwargs)
        try:
            return self._run_dtensor(func, args, kwargs)
        except Exception as e:
            error = e
        for how, conv in (("model-replicated", lambda a: _replicate(a, ("model",))),
                          ("replicated", lambda a: _replicate(a, None)),
                          ("local", _local)):
            try:
                out = self._run_dtensor(func, args, kwargs, conv)
            except Exception:
                continue
            if func._schema.is_mutable and isinstance(args[0], DTensor):
                raise error  # the write would land on a copy
            note = f"{func} on {how} inputs ({type(error).__name__})"
            self.notes[note] = self.notes.get(note, 0) + 1
            return out
        raise error

    def _run_dtensor(self, func, args, kwargs, conv=None):
        """``func`` with this mode re-entered: the DTensor-level op passes to
        DTensor (``NotImplemented``), its local ops and those of ``conv``'s
        redistributions, applied to the arguments first, come back here."""
        self._in_dtensor = True
        try:
            with self:
                if conv is not None:
                    args, kwargs = tree_map(conv, args), tree_map(conv, kwargs)
                return func(*args, **kwargs)
        finally:
            self._in_dtensor = False


def _replicate(a, axes):
    """A DTensor redistributed to ``Replicate`` over ``axes`` (all if None)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(a, DTensor):
        return a
    mesh = a.device_mesh
    target = [Replicate() if axes is None or n in axes else p
              for n, p in zip(mesh.mesh_dim_names, a.placements)]
    return a.redistribute(mesh, target)


def _local(a):
    """A DTensor's full value as a plain tensor."""
    return _replicate(a, None).to_local() if hasattr(a, "to_local") else a


def run_step(fn, args):
    """``fn(*args)`` once under the census, with plain tensors made in the
    step (``torch.arange``, constants) read as replicated.  Returns
    (result, the census, the fallbacks' notes)."""
    from torch.distributed.tensor.experimental import implicit_replication

    counter = DryRunCounter()
    with implicit_replication(), counter:
        out = fn(*args)
    return out, counter, counter.notes


def run_one(
    arch: str, shape_name: str, multi_pod: bool, out_dir: str, force: bool = False
) -> Dict[str, Any]:
    cfg = registry.get(arch)
    shape = shp.ALL_SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    record: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "status": "skipped",
    }
    if not shp.applicable(cfg, shape):
        record["reason"] = "long_500k skipped: pure full-attention arch"
        _write(out_path, record)
        return record

    t0 = time.time()
    try:
        start_fake_group(mesh_device_count(multi_pod))
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        chips = mesh.size()
        if shape.kind == "train":
            fn, args = build_train(cfg, shape, mesh)
        elif shape.kind == "prefill":
            fn, args = build_prefill(cfg, shape, mesh)
        else:
            fn, args = build_decode(cfg, shape, mesh)
        arg_bytes = local_bytes(args)
        t_build = time.time() - t0
        moe.combines = 0
        _, counter, fallbacks = run_step(fn, args)
        t_step = time.time() - t0 - t_build
        cost = counter.cost()
        mem = {
            "argument_size_in_bytes": arg_bytes,
            "temp_size_in_bytes": counter.peak_bytes,
            "bytes_per_chip": arg_bytes + counter.peak_bytes,
        }
        report = analysis.analyze(cfg, shape, mesh_name, chips, cost, mem)
        record.update(
            status="ok",
            chips=chips,
            lower_s=round(t_build, 2),
            compile_s=round(t_step, 2),
            cost={"flops": cost.flops, "transcendentals": cost.transcendentals,
                  "bytes accessed": cost.mem_bytes, "ops": counter.ops},
            memory=mem,
            roofline=report.row(),
            hlo_bytes_len=None,
            notes={"fallbacks": fallbacks, "expert_parallel_combines": moe.combines},
        )
    except Exception as e:  # a combo that fails is recorded, and the grid goes on
        record.update(status="error", error=repr(e), trace=traceback.format_exc())
    record["elapsed_s"] = round(time.time() - t0, 2)
    _write(out_path, record)
    return record


def _write(path: str, record: Dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=str)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else registry.list_archs()
    shape_names = [args.shape] if args.shape else list(shp.ALL_SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    n_ok = n_err = n_skip = 0
    try:
        for arch in archs:
            for shape_name in shape_names:
                for multi in meshes:
                    rec = run_one(arch, shape_name, multi, args.out, args.force)
                    tag = rec["status"]
                    if tag == "ok":
                        n_ok += 1
                        r = rec["roofline"]
                        print(
                            f"OK   {arch:22s} {shape_name:12s} {rec['mesh']:10s} "
                            f"step={rec.get('compile_s', 0):7.1f}s "
                            f"dom={r['dominant']:10s} "
                            f"c={r['compute_s']:.2e} m={r['memory_s']:.2e} "
                            f"n={r['collective_s']:.2e}",
                            flush=True,
                        )
                    elif tag == "skipped":
                        n_skip += 1
                        print(f"SKIP {arch:22s} {shape_name:12s} {rec['mesh']}", flush=True)
                    else:
                        n_err += 1
                        print(
                            f"ERR  {arch:22s} {shape_name:12s} {rec['mesh']}: "
                            f"{rec['error'][:200]}",
                            flush=True,
                        )
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"done: ok={n_ok} skipped={n_skip} errors={n_err}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
