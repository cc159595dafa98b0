"""Deterministic, sharded, checkpointable data pipelines.

Token pipeline: an (optionally memmapped) token corpus is consumed in
globally-consistent steps; each DP rank slices its rows from the global
batch by rank index, and the cursor (= step) is the only state — restoring a
checkpoint at step N resumes the exact batch sequence (restart determinism).
Vector pipeline: streaming insert/delete workload generator for the ANNS
update benchmarks (paper Exp#5's 50%-replacement schedule).

Numpy only, a copy of the reference's: ``batch_at`` and ``cycles`` equal
the reference's bit for bit (the port's ``make_token_batch`` and
``make_vector_dataset`` are its generators).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .synthetic import make_token_batch, make_vector_dataset


@dataclass
class TokenPipeline:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    corpus: np.ndarray | None = None      # [N, seq+1] optional real tokens

    def batch_at(self, step: int, *, rank: int = 0, world: int = 1) -> dict:
        """Global step -> this rank's slice {tokens, labels}."""
        per = self.global_batch // world
        if self.corpus is not None:
            n = len(self.corpus)
            idx = (step * self.global_batch + rank * per +
                   np.arange(per)) % n
            rows = self.corpus[idx]
        else:
            rows = make_token_batch(self.vocab, per, self.seq_len + 1,
                                    seed=self.seed + step * 1009 + rank)
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclass
class StreamingVectorWorkload:
    """Paper Exp#5 schedule: replace `replace_frac` of the dataset over
    `iterations` merge cycles (each deletes and inserts frac/iterations)."""
    base: np.ndarray
    replace_frac: float = 0.5
    iterations: int = 10
    seed: int = 7

    def cycles(self):
        rng = np.random.default_rng(self.seed)
        n, d = self.base.shape
        per = int(n * self.replace_frac / self.iterations)
        live = list(range(n))
        next_id = n
        for it in range(self.iterations):
            dead = rng.choice(len(live), size=per, replace=False)
            delete_ids = [live[i] for i in sorted(dead, reverse=True)]
            for i in sorted(dead, reverse=True):
                live.pop(i)
            fresh_ids = np.arange(next_id, next_id + per)
            next_id += per
            fresh_vecs = make_vector_dataset(
                "prop-like", per, d, seed=self.seed + 100 + it
            ).astype(self.base.dtype)
            live.extend(fresh_ids.tolist())
            yield {"iteration": it, "delete": np.asarray(delete_ids),
                   "insert_ids": fresh_ids, "insert_vecs": fresh_vecs}
