"""The four assigned input shapes and per-(arch, shape) input specs.

``token_inputs(cfg, shape)`` describes every model input of one step as a
``TensorSpec`` (shape and torch dtype), with no allocation: the port's
stand-in for the reference's ``jax.ShapeDtypeStruct``.

Decode shapes describe ``decode_step`` (ONE new token against a KV cache
of ``seq_len``), not a train step; ``long_500k`` only applies to archs
whose ``supports_long_context()`` is True.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype, with no storage."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

ALL_SHAPES = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def applicable(cfg: ArchConfig, shape: InputShape) -> bool:
    """Whether (arch, shape) is in the assigned 40-combo matrix minus the
    documented skips (long_500k for pure full-attention archs)."""
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return False
    return True


def token_inputs(
    cfg: ArchConfig, shape: InputShape, dtype=torch.int32
) -> Dict[str, TensorSpec]:
    """Specs of the model inputs of one step."""
    b, s = shape.global_batch, shape.seq_len
    sds = lambda shp, dt: TensorSpec(tuple(shp), dt)

    if shape.kind == "train":
        specs = {
            "tokens": sds((b, s), dtype),
            "targets": sds((b, s), dtype),
            # 1.0 for real tokens; lets the loss mask padding.
            "loss_mask": sds((b, s), torch.float32),
        }
        if cfg.mrope:
            # positions cover frontend embeddings + text stream
            specs["positions"] = sds((3, b, s + cfg.frontend_tokens), dtype)
        if cfg.modality in ("audio", "vision"):
            specs["frontend_embeds"] = sds(
                (b, cfg.frontend_tokens, cfg.d_model), torch.bfloat16
            )
        if cfg.encoder_layers:
            specs["encoder_tokens"] = sds(
                (b, cfg.frontend_tokens, cfg.d_model), torch.bfloat16
            )
            del specs["frontend_embeds"]
        return specs

    if shape.kind == "prefill":
        specs = {"tokens": sds((b, s), dtype)}
        if cfg.mrope:
            specs["positions"] = sds((3, b, s + cfg.frontend_tokens), dtype)
        if cfg.encoder_layers:
            specs["encoder_tokens"] = sds(
                (b, cfg.frontend_tokens, cfg.d_model), torch.bfloat16
            )
        elif cfg.modality in ("audio", "vision"):
            specs["frontend_embeds"] = sds(
                (b, cfg.frontend_tokens, cfg.d_model), torch.bfloat16
            )
        return specs

    # decode: one new token per sequence + the running position
    specs = {
        "tokens": sds((b, 1), dtype),
        "positions": sds((3, b, 1), dtype) if cfg.mrope else sds((b,), dtype),
    }
    return specs


def concrete_token_inputs(cfg: ArchConfig, shape: InputShape, seed: int = 0,
                          device="cuda"):
    """Small *materialized* inputs for smoke tests (reduced configs), drawn
    from numpy as the reference draws them, on ``device``."""
    rng = np.random.default_rng(seed)
    specs = token_inputs(cfg, shape)
    out = {}
    for k, s in specs.items():
        if not s.dtype.is_floating_point:
            hi = max(cfg.vocab_size - 1, 2) if "token" in k else max(s.shape[-1], 2)
            x = torch.as_tensor(rng.integers(0, hi, size=s.shape))
        else:
            # float64 draws rounded once to float32, then to the spec's dtype
            x = torch.as_tensor(rng.normal(0, 0.02, size=s.shape).astype(np.float32))
        out[k] = x.to(device=device, dtype=s.dtype)
    return out
