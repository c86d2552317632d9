"""Step builders of the port. Serving and prefill are ported; training
(``make_train_step``, the loss, the optimizer) comes with the training
slice (``ROADMAP.md`` Queue 1, item 6)."""
from .step import make_decode_caches, make_prefill_step, make_serve_step

__all__ = ["make_decode_caches", "make_prefill_step", "make_serve_step"]
