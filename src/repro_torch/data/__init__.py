"""Data substrate: synthetic datasets + resumable pipelines (numpy only)."""
from repro_torch.data.pipeline import DatasetRef, TrainLoader, chunk_ranges  # noqa: F401
from repro_torch.data.synthetic import imdb_reviews, lm_batches, lm_tokens  # noqa: F401
