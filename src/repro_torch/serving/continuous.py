"""Continuous batching: requests join/leave a running decode batch.

The static ``Engine`` prefills one batch and decodes it to completion —
fine for benchmarking, wasteful for serving (short requests hold their
slot while long ones finish). This engine keeps a fixed number of decode
*slots*; whenever one frees, the next queued request is prefilled alone
and its cache rows are spliced into the batched cache at that slot
(every cache tensor carries batch at a fixed axis, and ``Cache.position``
is already per-sequence, so mixed-progress decoding works unchanged).

As in the reference, every step decodes every slot, free ones too: a
free slot's position keeps growing, and past ``max_len`` its KV writes
land on the last cache slot (``attention._cache_write`` clamps as
``dynamic_update_slice`` does).  The free slots' tokens are never read.

Serial-dependency note (paper Fig. 3B): continuous batching is
across-request parallelism with per-request serial decode, the structure
the paper says offloading suits best.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.serving.engine import Completion, Request, params_device

# cache fields whose batch dim sits at axis 1 (leading axis is layers)
_BATCH_AXIS1 = (
    "attn_k", "attn_v", "mla_c", "mla_rope", "ssm_conv_x", "ssm_conv_bc",
    "ssm_state", "shared_k", "shared_v", "cross_k", "cross_v",
    "local_k", "local_v",
)


def _splice_slot(batch_cache, one_cache, slot: int):
    """Write a single-sequence cache into batch slot `slot`."""
    updates = {}
    for name in batch_cache._fields:
        big = getattr(batch_cache, name)
        small = getattr(one_cache, name)
        if big is None:
            continue
        if name == "position":
            pos = big.clone()
            if -pos.shape[0] <= slot < pos.shape[0]:  # out of range: dropped
                pos[slot] = small[0]
            updates[name] = pos
        elif name in _BATCH_AXIS1:
            updates[name] = transformer.dynamic_update_slice(
                big, small, (0, slot) + (0,) * (big.ndim - 2))
    return batch_cache._replace(**updates)


@dataclasses.dataclass
class _Slot:
    uid: Optional[int] = None
    remaining: int = 0
    generated: Optional[List[int]] = None
    prefill_len: int = 0

    @property
    def free(self) -> bool:
        return self.uid is None


class ContinuousEngine:
    """Fixed-slot continuous batching engine (greedy decoding), on the
    parameters' device."""

    def __init__(self, cfg: ArchConfig, params, num_slots: int = 4,
                 max_len: int = 512):
        self.cfg = cfg
        self.params = params
        self.num_slots = num_slots
        self.max_len = max_len
        self.device = params_device(params)
        self.queue: Deque[Request] = deque()
        self.slots = [_Slot() for _ in range(num_slots)]
        self.cache = transformer.init_cache(cfg, num_slots, max_len, device=self.device)
        self.next_tokens = torch.zeros((num_slots, 1), dtype=torch.int32, device=self.device)
        self.completions: List[Completion] = []

        self._prefill1 = lambda p, toks: transformer.prefill(cfg, p, toks, max_len=max_len)
        self._decode = lambda p, cache, toks: transformer.decode_step(cfg, p, cache, toks)

    # ------------------------------------------------------------------
    def submit(self, request: Request) -> None:
        self.queue.append(request)

    def _admit(self) -> None:
        for slot_idx, slot in enumerate(self.slots):
            if not slot.free or not self.queue:
                continue
            req = self.queue.popleft()
            toks = torch.as_tensor(np.asarray(req.prompt, np.int32), device=self.device)[None, :]
            logits, one_cache = self._prefill1(self.params, toks)
            first = int(torch.argmax(logits[0]))
            self.cache = _splice_slot(self.cache, one_cache, slot_idx)
            self.next_tokens[slot_idx, 0] = first
            self.slots[slot_idx] = _Slot(
                uid=req.uid,
                remaining=req.max_new_tokens - 1,
                generated=[first],
                prefill_len=int(toks.shape[1]),
            )
            if self.slots[slot_idx].remaining == 0:
                self._finish(slot_idx)

    def _finish(self, slot_idx: int) -> None:
        slot = self.slots[slot_idx]
        self.completions.append(
            Completion(
                uid=slot.uid,
                tokens=np.asarray(slot.generated, np.int32),
                prefill_len=slot.prefill_len,
            )
        )
        self.slots[slot_idx] = _Slot()

    @torch.no_grad()
    def step(self) -> int:
        """Admit + one decode step for every active slot. Returns the
        number of still-active slots."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if not s.free]
        if not active:
            return 0
        logits, self.cache = self._decode(self.params, self.cache, self.next_tokens)
        nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        self.next_tokens = nxt[:, None]
        nxt = nxt.cpu().numpy()
        for i in active:
            slot = self.slots[i]
            slot.generated.append(int(nxt[i]))
            slot.remaining -= 1
            if slot.remaining <= 0:
                self._finish(i)
        return sum(0 if s.free else 1 for s in self.slots)

    def run_to_completion(self, max_steps: int = 10_000) -> List[Completion]:
        steps = 0
        while (self.queue or any(not s.free for s in self.slots)) and steps < max_steps:
            self.step()
            steps += 1
        out = sorted(self.completions, key=lambda c: c.uid)
        return out
