"""Training substrate: losses and the functions that make train, prefill
and decode steps (``TrainJob`` lives in ``repro_torch.runtime.driver``), as
in the JAX package's ``repro.train``."""
from .loss import make_loss_fn, xent_chunked, xent_full
from .step import make_decode_step, make_prefill_step, make_train_step

__all__ = [
    "make_loss_fn",
    "xent_full",
    "xent_chunked",
    "make_train_step",
    "make_prefill_step",
    "make_decode_step",
]
