"""Deterministic, shard-aware synthetic token pipeline.

The counterpart of ``repro/data/pipeline.py``, with the same properties:

* **determinism by (step, position)**: a batch is a pure function of the
  seed, the global step and the global row, so a restart resumes on the
  same data whatever the host count;
* **host-sharded**: each process makes only its slice of the global batch
  (``process_index`` / ``process_count``), and the slices concatenate to
  the global batch;
* **learnable structure**: tokens follow the noisy affine recurrence
  ``t' = (31·t + 17) mod V`` with flip probability ``noise``;
  ``mode="uniform"`` gives i.i.d. tokens.

Row r of step s draws from ``np.random.default_rng(SeedSequence([seed, s,
r]))``: its start, its flips and its replacement tokens. The reference's
``jax.random.fold_in`` keys have no torch or numpy counterpart, so the bits
differ from the reference's by design (ROADMAP.md, queue 3); the recurrence,
the flip rule and the shapes are the same.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mode: str = "structured"          # structured | uniform
    noise: float = 0.05
    process_index: int = 0
    process_count: int = 1

    def __post_init__(self):
        if self.global_batch % self.process_count:
            raise ValueError("global_batch must divide over processes")
        if self.mode not in ("structured", "uniform"):
            raise ValueError(f"unknown mode {self.mode!r}")
        self.local_batch = self.global_batch // self.process_count
        self._a = 31 % self.vocab or 1
        self._c = 17 % self.vocab

    def _row_rng(self, step: int, row: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, row]))

    def batch(self, step: int) -> dict:
        """→ {"tokens": (local_B, S) int32, "targets": (local_B, S) int32},
        CPU tensors; targets are the tokens shifted by one."""
        rows = np.arange(self.local_batch) + self.process_index * \
            self.local_batch
        n = self.seq_len + 1
        rngs = [self._row_rng(step, int(r)) for r in rows]
        if self.mode == "uniform":
            toks = np.stack([g.integers(0, self.vocab, n) for g in rngs])
        else:
            starts = np.array([g.integers(0, self.vocab) for g in rngs])
            flips = np.stack([g.random(n) < self.noise for g in rngs])
            rand = np.stack([g.integers(0, self.vocab, n) for g in rngs])
            toks = np.empty((len(rows), n), dtype=np.int64)
            t = starts
            for i in range(n):
                t = np.where(flips[:, i], rand[:, i],
                             (self._a * t + self._c) % self.vocab)
                toks[:, i] = t
        toks = torch.from_numpy(toks.astype(np.int32))
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def make_batch_specs(cfg, shape, dtype=torch.int32) -> dict:
    """Stand-ins for the training batch that hold no memory: tensors on the
    ``meta`` device, the torch counterpart of ``jax.ShapeDtypeStruct``."""
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": torch.empty((b, s), dtype=dtype, device="meta"),
            "targets": torch.empty((b, s), dtype=dtype, device="meta")}
