"""Batched serving engine: prefill + decode loop over request batches.

The serial dependency the paper analyzes for frames (Fig. 3 category A)
is exactly the autoregressive decode dependency: token t+1 cannot be
issued before token t returns. The engine therefore exposes the same
stage structure the hand tracker does, and ``serving/edge.py`` applies
the identical offload machinery to it.

The engine runs where its parameters are.  Prompts are left-padded with
token 0 and the padding is attended, as in the reference.  Sampling at
temperature > 0 is the Gumbel-max draw of a categorical over
``logits / temperature``, from the engine's ``torch.Generator`` (seeded
by ``seed``, on the parameters' device).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int = 32


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: np.ndarray  # (N,) generated ids
    prefill_len: int


def _pad_prompts(prompts: List[np.ndarray], pad_id: int = 0, device="cuda"):
    maxlen = max(p.shape[0] for p in prompts)
    batch = np.full((len(prompts), maxlen), pad_id, np.int32)
    for i, p in enumerate(prompts):
        batch[i, maxlen - p.shape[0]:] = p  # left-pad: ends align
    return torch.as_tensor(batch, device=device), maxlen


def params_device(params) -> torch.device:
    """The device a parameter tree lives on."""
    return transformer.tree_leaves(params)[0][1].device


class Engine:
    """Static-batch serving engine (``ContinuousEngine`` is the
    continuous-batching one)."""

    def __init__(
        self,
        cfg: ArchConfig,
        params,
        max_len: int = 512,
        temperature: float = 0.0,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.temperature = temperature
        self.device = params_device(params)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self._prefill = lambda p, toks: transformer.prefill(cfg, p, toks, max_len=max_len)
        self._decode = lambda p, cache, toks: transformer.decode_step(cfg, p, cache, toks)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        u = torch.rand(logits.shape, generator=self.generator, device=self.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        return torch.argmax(logits / self.temperature + gumbel, dim=-1).to(torch.int32)

    @torch.no_grad()
    def generate(self, requests: List[Request]) -> List[Completion]:
        prompts = [r.prompt for r in requests]
        tokens, plen = _pad_prompts(prompts, device=self.device)
        logits, cache = self._prefill(self.params, tokens)
        steps = max(r.max_new_tokens for r in requests)
        out = []
        cur = self._sample(logits)
        generated = [cur]
        for _ in range(steps - 1):
            step_logits, cache = self._decode(self.params, cache, cur[:, None])
            cur = self._sample(step_logits[:, 0])
            generated.append(cur)
        gen = torch.stack(generated, dim=1).cpu().numpy()  # (B, steps)
        for i, r in enumerate(requests):
            out.append(
                Completion(
                    uid=r.uid,
                    tokens=gen[i, : r.max_new_tokens],
                    prefill_len=plen,
                )
            )
        return out
