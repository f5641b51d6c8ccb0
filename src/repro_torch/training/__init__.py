"""Training substrate: optimizers, train-step builder, checkpointing.

Counterpart of ``repro.training``, with the same exports."""
from repro_torch.training import checkpoint  # noqa: F401
from repro_torch.training.optimizer import (  # noqa: F401
    Adafactor, AdamW, constant, warmup_cosine)
from repro_torch.training.train_step import (  # noqa: F401
    make_loss_fn, make_train_step)
