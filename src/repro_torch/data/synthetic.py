"""Synthetic datasets, seeded and fully offline.

``imdb_reviews`` mirrors the paper's case-study dataset shape: 25k balanced
movie reviews for binary sentiment classification. Reviews are token
sequences drawn from a Zipfian vocabulary with a planted class signal
(sentiment-bearing token clusters appear with class-dependent frequency),
so a trained classifier genuinely separates the classes — inference on it
is a real workload, not noise.

``lm_tokens`` provides next-token-prediction streams for the LM examples.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _zipf_probs(vocab: int, alpha: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return p / p.sum()


def imdb_reviews(n: int = 25_000, seq_len: int = 256, vocab: int = 30_522,
                 seed: int = 0,
                 signal_frac: float = 0.08) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (tokens (n, seq_len) int32, labels (n,) int32), balanced."""
    rng = np.random.default_rng(seed)
    base = _zipf_probs(vocab)
    labels = np.arange(n) % 2
    rng.shuffle(labels)
    # sentiment-bearing token ranges (disjoint, mid-frequency), scaled to
    # the vocab so reduced smoke vocabularies keep distinct class banks
    bank = max(4, vocab // 32)
    start = vocab // 4
    pos_tokens = np.arange(start, start + bank)
    neg_tokens = np.arange(start + bank, start + 2 * bank)
    tokens = rng.choice(vocab, size=(n, seq_len), p=base).astype(np.int32)
    n_signal = max(1, int(seq_len * signal_frac))
    for cls, bank in ((1, pos_tokens), (0, neg_tokens)):
        rows = np.where(labels == cls)[0]
        cols = rng.integers(1, seq_len, size=(len(rows), n_signal))
        vals = rng.choice(bank, size=(len(rows), n_signal))
        tokens[rows[:, None], cols] = vals
    tokens[:, 0] = 101  # [CLS]
    return tokens, labels.astype(np.int32)


def lm_tokens(n_tokens: int, vocab: int, seed: int = 0,
              order: int = 2) -> np.ndarray:
    """Markov-ish token stream: learnable low-entropy structure."""
    rng = np.random.default_rng(seed)
    base = _zipf_probs(vocab)
    toks = rng.choice(vocab, size=n_tokens, p=base).astype(np.int32)
    # plant bigram determinism on a subset: token t -> (t*7+1) % vocab
    mask = rng.random(n_tokens - 1) < 0.5
    toks[1:][mask] = (toks[:-1][mask] * 7 + 1) % vocab
    return toks


def lm_batches(tokens: np.ndarray, batch: int, seq_len: int, seed: int = 0):
    """Yields dicts {tokens, labels} of next-token-prediction batches."""
    n_seq = (len(tokens) - 1) // seq_len
    x = tokens[:n_seq * seq_len].reshape(n_seq, seq_len)
    y = tokens[1:n_seq * seq_len + 1].reshape(n_seq, seq_len)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n_seq)
    for i in range(0, n_seq - batch + 1, batch):
        idx = order[i:i + batch]
        yield {"tokens": x[idx], "labels": y[idx]}
