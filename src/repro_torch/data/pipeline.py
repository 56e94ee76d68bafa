"""Deterministic synthetic token pipeline — host-sharded, restart-safe
(port of ``repro.data.pipeline``: numpy only, the same batches bit for
bit; the JAX module's unused ``jax`` imports are left out).

Production framing: each host materialises only ITS shard of the global
batch (`host_count`/`host_id`), batches are a pure function of the step
index (counter-based PRNG), so (a) a restarted job regenerates the exact
stream from the checkpointed step — data and model state never desync —
and (b) there is no cross-host data coordination at all.

The synthetic distribution is a Zipfian unigram mix with a deterministic
"copy motif" (spans repeated later in the sequence) so models have
learnable structure and the loss visibly drops within a few hundred steps
(used by examples/train_lm.py).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    host_count: int = 1
    host_id: int = 0
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 16

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.host_count == 0
        return self.global_batch // self.host_count

    def _unigram(self) -> np.ndarray:
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        p = ranks ** (-self.zipf_a)
        return p / p.sum()

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Pure function of (step, host_id): {'tokens', 'targets'} int32."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id])
        )
        shape = (self.host_batch, self.seq_len + 1)
        toks = rng.choice(self.vocab, size=shape, p=self._unigram())
        # copy motif: repeat a span to create in-context structure
        m = self.motif_len
        if self.seq_len > 4 * m:
            src = rng.integers(0, self.seq_len // 2 - m, self.host_batch)
            dst = rng.integers(self.seq_len // 2, self.seq_len - m,
                               self.host_batch)
            for b in range(self.host_batch):
                toks[b, dst[b]:dst[b] + m] = toks[b, src[b]:src[b] + m]
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def make_train_iterator(
    spec: SyntheticTokens, start_step: int = 0
) -> Iterator[dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield spec.batch_at(step)
        step += 1
