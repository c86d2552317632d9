"""Step builders, the LM loss and the fault-tolerant trainer of the port
(``trainer.py`` registers the ``train_chunk`` task when imported)."""
from .loss import lm_loss
from .step import (TrainState, init_train_state, make_decode_caches,
                   make_prefill_step, make_serve_step, make_train_step,
                   shard_train_state, train_state_shapes)

__all__ = ["TrainState", "init_train_state", "lm_loss", "make_decode_caches",
           "make_prefill_step", "make_serve_step", "make_train_step",
           "shard_train_state", "train_state_shapes"]
