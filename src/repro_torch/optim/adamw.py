"""AdamW optimizer over nested dicts of tensors.

The reference's ``repro.optim.adamw`` on the port, with its arithmetic:
moments live in float32 whatever the parameter dtype (bfloat16 training
stability), the update is clipped by the global gradient norm, and the
decoupled weight decay is added to the normalized step before the
learning rate scales it (``torch.optim.AdamW`` decays first, in another
order of rounding, and clips nothing).

``update`` writes the new moments and parameters into the tensors it is
given and returns them: the reference's jitted train step donates its
parameters and optimizer state, so no caller reads the old values, and
the moments of a full-width model are too large to hold twice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.models.transformer import tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def _zip_leaves(*trees):
    """Tuples of the trees' leaves, in sorted key order (the reference's
    leaf order); every tree has the first one's keys."""
    if isinstance(trees[0], dict):
        for k in sorted(trees[0]):
            yield from _zip_leaves(*(t[k] for t in trees))
    else:
        yield trees


# Elements in one piece of a leaf: the update is elementwise, so a large
# leaf (a full-width embedding table is 524M elements) is updated a block
# of rows at a time, and its float32 temporaries stay at 256 MiB.
_PIECE = 1 << 26


def _pieces(*leaves):
    """Matching row blocks of same-shaped leaves, at most ``_PIECE``
    elements each (views: an in-place update of a piece updates its leaf)."""
    t = leaves[0]
    if t.ndim == 0 or t.numel() <= _PIECE:
        return [leaves]
    rows = max(1, _PIECE // (t.numel() // t.shape[0]))
    return zip(*(x.split(rows) for x in leaves))


def init(params: Any) -> AdamWState:
    # zeros_like keeps a DTensor parameter's placements on its moments
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    (first,) = next(_zip_leaves(params))
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
    )


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(
        torch.sum(torch.square(x.to(torch.float32)))
        for leaf in _zip_leaves(tree) for (x,) in _pieces(*leaf)
    ))


@torch.no_grad()
def update(
    cfg: AdamWConfig,
    grads: Any,
    state: AdamWState,
    params: Any,
    lr_scale=1.0,
) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step.  Writes the new moments into ``state.mu``/``state.nu``
    and the new parameters (cast back to their dtype) into ``params``, and
    returns ``(params, AdamWState(step + 1, mu, nu), {"grad_norm": ...})``."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1.0 - torch.pow(b2, step.to(torch.float32))
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=gnorm.device)

    for leaves in _zip_leaves(grads, state.mu, state.nu, params):
        for g, m, v, p in _pieces(*leaves):
            # each product and sum rounded as in the reference's expression
            g = g.to(torch.float32) * clip
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_((g * (1 - b2)).mul_(g))
            delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
            p32 = p.to(torch.float32)
            delta.add_(cfg.weight_decay * p32)
            p.copy_(p32 - lr * delta)
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm}


def cosine_schedule(
    base_steps: int, warmup: int = 100, floor: float = 0.1
) -> Callable[[torch.Tensor], torch.Tensor]:
    def scale(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(base_steps - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return warm * cos

    return scale
