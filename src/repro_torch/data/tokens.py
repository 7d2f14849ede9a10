"""Synthetic LM token pipeline.

Deterministic, seekable, shard-aware synthetic corpus: a mixture of
Zipfian unigrams and repeated n-gram motifs so a ~100M model trained a
few hundred steps shows a *visibly decreasing* loss (pure-uniform tokens
would bottom out at ln V immediately), which is what the end-to-end
training example validates.

A copy of the reference's ``repro.data.tokens`` (numpy only): the port's
training driver moves its host batches to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    num_motifs: int = 64
    motif_prob: float = 0.5


class TokenPipeline:
    """Iterator of {tokens, targets, loss_mask} host batches."""

    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # Zipfian unigram table (bounded resampling)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._probs = (ranks ** -cfg.zipf_a) / np.sum(ranks ** -cfg.zipf_a)
        self._motifs = rng.integers(
            0, v, size=(cfg.num_motifs, cfg.motif_len), dtype=np.int32
        )
        self._step = 0

    def _sample_batch(self, rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        b, s = cfg.global_batch, cfg.seq_len
        out = rng.choice(
            cfg.vocab_size, size=(b, s + 1), p=self._probs
        ).astype(np.int32)
        # overwrite random spans with motifs (predictable structure)
        n_spans = int(s * cfg.motif_prob / cfg.motif_len)
        for i in range(b):
            starts = rng.integers(0, s + 1 - cfg.motif_len, size=n_spans)
            picks = rng.integers(0, cfg.num_motifs, size=n_spans)
            for st, pk in zip(starts, picks):
                out[i, st : st + cfg.motif_len] = self._motifs[pk]
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.cfg.seed + 1000 + self._step)
        self._step += 1
        seq = self._sample_batch(rng)
        return {
            "tokens": seq[:, :-1],
            "targets": seq[:, 1:],
            "loss_mask": np.ones(
                (self.cfg.global_batch, self.cfg.seq_len), np.float32
            ),
        }
