"""Training driver: real steps on one device (the card by default).

Usage (end-to-end example, reduced config, a few hundred steps):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --reduced \\
      --steps 300 --batch 8 --seq 256 [--device cuda]

The parameters are random, drawn from a ``torch.Generator`` seeded by
``seed`` on the device; the token batches come from the numpy
``TokenPipeline`` seeded the same way, as the reference draws them.
Gradients are ``torch.autograd.grad`` of ``loss_fn(..., remat=True)``;
the step updates the parameters and the optimizer state in place (the
reference's jitted step donates them).  ``tok/s`` is the host clock from
the first step to the logged one, which reads the loss from the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from contextlib import nullcontext
from typing import Dict, Optional

import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs import registry
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.models import transformer
from repro_torch.optim import adamw


def value_and_grad(cfg, params, batch, *, remat=True, shard=transformer._no_shard):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` on the port:
    ``((loss, metrics), grads)``, ``grads`` a tree like ``params`` from
    ``torch.autograd.grad``; a leaf the loss does not reach gets zeros,
    as JAX gives it."""
    live = transformer.tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = [t for _, t in transformer.tree_leaves(live)]
    with torch.enable_grad():
        loss, metrics = transformer.loss_fn(cfg, live, batch, shard=shard, remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    by_leaf = dict(zip(map(id, leaves), grads))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), transformer.tree_map(lambda t: by_leaf[id(t)], live)


def build_train_step(cfg, opt_cfg, mesh, schedule):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, metrics ``ce_loss``, ``aux_loss``, ``loss`` and
    ``grad_norm``.

    With ``mesh=None`` the step runs on one device.  With a ``DeviceMesh``
    the parameters, the AdamW state and the batch are DTensors on it
    (``sharding.specs``: ``distribute`` by ``param_specs`` and
    ``input_specs_tree``; ``adamw.init`` of the placed parameters); the
    model runs under the mesh's shard hook, and each gradient is
    redistributed to its parameter's placements before the update — over
    the data axes that is the all-reduce of the per-shard partial sums,
    as GSPMD inserts it.  The step's math is the same either way."""
    shard, place, context = transformer._no_shard, (lambda grads, params: grads), nullcontext
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor.experimental import implicit_replication

        from repro_torch.sharding import specs

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(
                f"the port trains over a torch DeviceMesh; a {type(mesh).__name__} is not one")
        shard = specs.make_shard_fn(mesh)
        place = lambda grads, params: _placed_like(grads, params, mesh)
        # tensors the model makes (positions, masks) read as replicated
        context = implicit_replication

    def train_step(params, opt_state, batch):
        with context():
            (loss, metrics), grads = value_and_grad(cfg, params, batch, remat=True,
                                                    shard=shard)
            grads = place(grads, params)
            lr_scale = schedule(opt_state.step)
            params, opt_state, opt_metrics = adamw.update(
                opt_cfg, grads, opt_state, params, lr_scale
            )
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def _placed_like(grads, params, mesh):
    """Each gradient redistributed to its parameter's placements."""
    if isinstance(grads, dict):
        return {k: _placed_like(g, params[k], mesh) for k, g in grads.items()}
    return grads.redistribute(mesh, params.placements)


def train_config(arch: str, reduced: bool = True, big: bool = False, seq: int = 256):
    """The config ``run`` trains: the registry's, or its reduced variant
    widened to at least 4 layers, d_model 512 and vocab 8,192 (``big``: the
    ~100M-class variant for accelerator hosts)."""
    cfg = registry.get(arch)
    if reduced:
        cfg = cfg.reduced()
        if big:
            # ~100M-class variant for real accelerator hosts
            cfg = dataclasses.replace(
                cfg,
                num_layers=12,
                d_model=768,
                num_heads=12 if cfg.num_heads else 0,
                num_kv_heads=4 if cfg.num_heads else 0,
                head_dim=64 if cfg.num_heads else 0,
                d_ff=3072 if cfg.d_ff else 0,
                vocab_size=32768,
                max_seq_len=max(cfg.max_seq_len, seq),
            )
        else:
            cfg = dataclasses.replace(
                cfg,
                num_layers=max(cfg.num_layers, 4),
                d_model=max(cfg.d_model, 512) if cfg.d_model < 512 else cfg.d_model,
                vocab_size=max(cfg.vocab_size, 8192),
                max_seq_len=max(cfg.max_seq_len, seq),
            )
    return cfg


def run(
    arch: str,
    steps: int = 300,
    batch: int = 8,
    seq: int = 256,
    reduced: bool = True,
    lr: float = 3e-4,
    seed: int = 0,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 100,
    log_every: int = 10,
    big: bool = False,
    device="cuda",
) -> Dict:
    cfg = train_config(arch, reduced, big, seq)
    device = torch.device(device)
    params = transformer.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device=device)
    n_params = sum(x.numel() for _, x in transformer.tree_leaves(params))

    opt_cfg = adamw.AdamWConfig(lr=lr)
    opt_state = adamw.init(params)
    schedule = adamw.cosine_schedule(steps)
    step_fn = build_train_step(cfg, opt_cfg, None, schedule)

    pipe = iter(
        TokenPipeline(
            TokenPipelineConfig(
                vocab_size=cfg.vocab_size,
                seq_len=seq,
                global_batch=batch,
                seed=seed,
            )
        )
    )

    losses = []
    t0 = time.time()
    for step in range(steps):
        host_batch = next(pipe)
        batch_dev = {k: torch.as_tensor(v, device=device) for k, v in host_batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch_dev)
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            losses.append((step, loss))
            tps = batch * seq * (step + 1) / (time.time() - t0)
            print(
                f"step {step:5d} loss {loss:7.4f} "
                f"grad_norm {float(metrics['grad_norm']):8.3f} tok/s {tps:9.0f}",
                flush=True,
            )
        if ckpt_dir and step and step % ckpt_every == 0:
            ckpt_io.save(ckpt_dir, step, {"params": params})

    first_loss, last_loss = losses[0][1], losses[-1][1]
    result = {
        "arch": cfg.name,
        "params": n_params,
        "steps": steps,
        "first_loss": first_loss,
        "final_loss": last_loss,
        "improved": last_loss < first_loss - 0.2,
        "losses": losses,
    }
    if ckpt_dir:
        ckpt_io.save(ckpt_dir, steps, {"params": params})
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.list_archs())
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = run(
        args.arch,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        lr=args.lr,
        reduced=args.reduced,
        ckpt_dir=args.ckpt_dir,
        device=args.device,
    )
    print(json.dumps({k: v for k, v in result.items() if k != "losses"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
