"""Modality frontend STUBS (the one mandated carve-out).

[audio] and [vlm] architectures specify the transformer backbone only;
the real frontends (mel-spectrogram + conformer codec for seamless-m4t,
ViT + dynamic-resolution projector for qwen2-vl) are NOT implemented.
Instead these helpers produce correctly-shaped frame/patch embeddings:
a ``TensorSpec`` for shapes, deterministic pseudo-embeddings drawn from
numpy as the reference draws them, and M-RoPE position grids for
qwen2-vl.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import TensorSpec


def frontend_spec(cfg: ArchConfig, batch: int) -> TensorSpec:
    """Shape of the precomputed embeddings the backbone consumes."""
    assert cfg.modality in ("audio", "vision"), cfg.modality
    return TensorSpec((batch, cfg.frontend_tokens, cfg.d_model),
                      getattr(torch, cfg.dtype))


def fake_frontend_embeds(
    cfg: ArchConfig, batch: int, seed: int = 0, device="cuda"
) -> torch.Tensor:
    """Deterministic stand-in embeddings (unit RMS like real encoders)."""
    rng = np.random.default_rng(seed)
    spec = frontend_spec(cfg, batch)
    x = rng.normal(0.0, 1.0, size=spec.shape).astype(np.float32)
    return torch.as_tensor(x).to(device=device, dtype=spec.dtype)


def mrope_positions(
    batch: int,
    text_len: int,
    image_grid: Optional[Tuple[int, int]] = None,
    temporal_offset: int = 0,
    device="cuda",
) -> torch.Tensor:
    """Qwen2-VL M-RoPE position ids, shape (3, B, S).

    Vision patches get (t=const, h=row, w=col); text tokens get equal
    (t, h, w) components continuing after the visual block — the layout
    of arXiv:2409.12191 §2.1.
    """
    i32 = dict(dtype=torch.int32, device=device)
    parts = []
    if image_grid is not None:
        gh, gw = image_grid
        t = torch.zeros((gh * gw,), **i32) + temporal_offset
        h = torch.repeat_interleave(torch.arange(gh, **i32), gw)
        w = torch.arange(gw, **i32).repeat(gh)
        parts.append(torch.stack([t, h, w]))
        start = temporal_offset + max(gh, gw)
    else:
        start = temporal_offset
    text = torch.arange(start, start + text_len, **i32)
    parts.append(text.expand(3, text_len))
    pos = torch.cat(parts, dim=1)  # (3, S)
    return pos[:, None, :].expand(3, batch, pos.shape[1]).contiguous()
