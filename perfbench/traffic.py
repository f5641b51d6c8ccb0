"""The one generator every traffic mix goes through.

A mix (``perfbench/traffic/<name>.json``) says how long the prompts are,
how many items a job holds and what kind of text they are; from
``--seed`` this module makes a corpus of ``corpus_jobs`` jobs' inputs
once, in set-up, and job ``k`` of the window takes the ``k``-th block of it
(round the corpus again past its end). Every seed gives the same sizes in
the same order; only the token ids differ.

Kinds of prompt:

- ``reviews``: IMDb-shaped reviews for the classifier: token ids from a
  Zipf(1.1) vocabulary, two sentiment banks planted at 8% of the
  positions by class, and [CLS] (id 101) at position 0 (the generator of
  ``repro_torch.data.synthetic.imdb_reviews``, copied);
- ``uniform``: prompt ids uniform over [1, vocab) (as
  ``repro_torch.batch.make_dataset`` draws them, copied).
"""
from __future__ import annotations

import numpy as np


def _zipf_probs(vocab: int, alpha: float = 1.1) -> np.ndarray:
    p = np.arange(1, vocab + 1, dtype=np.float64) ** (-alpha)
    return p / p.sum()


def reviews(rng, n: int, seq_len: int, vocab: int,
            signal_frac: float = 0.08) -> np.ndarray:
    labels = np.arange(n) % 2
    rng.shuffle(labels)
    bank = max(4, vocab // 32)
    start = vocab // 4
    banks = {1: np.arange(start, start + bank),
             0: np.arange(start + bank, start + 2 * bank)}
    tokens = rng.choice(vocab, size=(n, seq_len),
                        p=_zipf_probs(vocab)).astype(np.int32)
    n_signal = max(1, int(seq_len * signal_frac))
    for cls, ids in banks.items():
        rows = np.where(labels == cls)[0]
        cols = rng.integers(1, seq_len, size=(len(rows), n_signal))
        tokens[rows[:, None], cols] = rng.choice(ids, size=(len(rows),
                                                            n_signal))
    tokens[:, 0] = 101
    return tokens


def uniform(rng, n: int, seq_len: int, vocab: int) -> np.ndarray:
    return rng.integers(1, vocab, size=(n, seq_len), dtype=np.int32)


KINDS = {"reviews": reviews, "uniform": uniform}


class Corpus:
    """The window's inputs: ``job(k)`` is job ``k``'s (items, S) prompts."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.per_job = mix["items_per_job"]
        self.n_jobs = mix["corpus_jobs"]
        seq_len = mix.get("seq_len", mix.get("prompt_len"))
        rng = np.random.default_rng([seed, 0x7a11])
        self.tokens = KINDS[mix["prompts"]](
            rng, self.per_job * self.n_jobs, seq_len, vocab)

    def job(self, k: int) -> np.ndarray:
        lo = (k % self.n_jobs) * self.per_job
        return self.tokens[lo:lo + self.per_job]
