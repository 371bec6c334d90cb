"""Deterministic, step-indexed synthetic token pipeline.

``batch(step)`` is a pure function of (seed, step) — after a restart the
loop resumes at step N and regenerates exactly the batches it would have
seen, so checkpoint/restart never replays or skips data (DESIGN.md §5
fault tolerance). Zipfian unigram stream with local bigram structure so the
loss has signal to descend.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    frontend: str = "none"   # none | patch | frame (stub embeddings)
    d_model: int = 0

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def get_batch(self, step: int) -> dict[str, np.ndarray]:
        rng = self._rng(step)
        v = self.vocab_size
        # zipf unigrams with a repeat-previous bigram bias (learnable signal)
        base = rng.zipf(1.3, size=(self.batch, self.seq_len + 1)) % v
        rep = rng.random((self.batch, self.seq_len + 1)) < 0.3
        toks = base.copy()
        toks[:, 1:] = np.where(rep[:, 1:], toks[:, :-1], base[:, 1:])
        toks = toks.astype(np.int32)
        if self.frontend in ("patch", "frame"):
            emb = rng.standard_normal(
                (self.batch, self.seq_len, self.d_model)).astype(np.float32)
            key = "embeds" if self.frontend == "patch" else "frames"
            out = {key: emb, "labels": toks[:, 1:]}
            if self.frontend == "frame":
                dec_len = max(self.seq_len // 8, 16)
                out["tokens"] = toks[:, :dec_len]
                out["labels"] = toks[:, 1:dec_len + 1]
            return out
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
