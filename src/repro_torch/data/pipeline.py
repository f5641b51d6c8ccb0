"""Host data pipeline: resumable sharded loaders + chunk iterators.

``DatasetRef`` + ``chunk_ranges`` are what core/decompose.py operates on:
the paper's batch decomposition is expressed as index ranges over a
dataset, so chunking is pure metadata (no data copies at plan time).
The training loader carries an explicit cursor for checkpoint/resume.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetRef:
    """Metadata handle to a dataset stored in the artifact store."""

    name: str
    n_items: int
    seq_len: int
    vocab: int


def chunk_ranges(n_items: int, chunk_size: int) -> List[Tuple[int, int]]:
    """[start, end) ranges covering exactly [0, n_items)."""
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    return [(i, min(i + chunk_size, n_items))
            for i in range(0, n_items, chunk_size)]


@dataclasses.dataclass
class TrainLoader:
    """Resumable batch iterator with an explicit integer cursor."""

    tokens: np.ndarray  # (n_seq, seq_len)
    labels: np.ndarray
    batch: int
    seed: int = 0
    cursor: int = 0  # number of batches already served (checkpointable)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._order = rng.permutation(len(self.tokens))

    @property
    def batches_per_epoch(self) -> int:
        return len(self.tokens) // self.batch

    def next_batch(self) -> dict:
        bpe = self.batches_per_epoch
        epoch, step = divmod(self.cursor, bpe)
        if step == 0 and epoch > 0:  # reshuffle per epoch, seeded
            rng = np.random.default_rng(self.seed + epoch)
            self._order = rng.permutation(len(self.tokens))
        idx = self._order[step * self.batch:(step + 1) * self.batch]
        self.cursor += 1
        return {"tokens": self.tokens[idx], "labels": self.labels[idx]}

    def state(self) -> dict:
        return {"cursor": self.cursor, "seed": self.seed}

    def restore(self, state: dict):
        self.cursor = int(state["cursor"])
        assert state["seed"] == self.seed, "loader seed mismatch on restore"
        epoch = self.cursor // max(self.batches_per_epoch, 1)
        rng = np.random.default_rng(self.seed + epoch if epoch else self.seed)
        self._order = rng.permutation(len(self.tokens))
