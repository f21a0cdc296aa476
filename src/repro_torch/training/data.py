"""Synthetic LM data pipeline: learnable structure (a noisy Markov chain
over the vocab) so training loss demonstrably falls below the uniform
entropy floor. Deterministic given the seed; infinite iterator of batches."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class SyntheticLMData:
    def __init__(self, vocab: int, seq: int, batch: int, *, seed: int = 0,
                 branching: int = 8):
        self.vocab, self.seq, self.batch = vocab, seq, batch
        rng = np.random.default_rng(seed)
        # each token has `branching` likely successors
        self.succ = rng.integers(0, vocab, size=(vocab, branching))
        self.rng = np.random.default_rng(seed + 1)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b, s = self.batch, self.seq
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = self.rng.integers(0, self.vocab, b)
        for t in range(1, s):
            choice = self.rng.integers(0, self.succ.shape[1], b)
            nxt = self.succ[toks[:, t - 1], choice]
            noise = self.rng.random(b) < 0.05
            nxt = np.where(noise, self.rng.integers(0, self.vocab, b), nxt)
            toks[:, t] = nxt
        return {"tokens": toks}
