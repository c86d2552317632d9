"""Deterministic, offset-addressable synthetic LM data.

``batch_at(seed, step, ...)`` is a pure function of (seed, step): the same
step index always produces the same batch, on any host. That is the property
that makes KSA step-chunk tasks idempotent — a redelivered chunk (agent
death, straggler resubmission) replays exactly the same data, so training is
bit-reproducible across failures — and it removes data-loader checkpointing
entirely (the data "checkpoint" is just the step counter).

The stream is a Markov-ish token process (not uniform noise) so smoke-scale
models actually have structure to learn; frontends get Gaussian embeddings
derived from the same counters.
"""
from __future__ import annotations

import numpy as np

from repro_torch.models.config import ModelConfig


def batch_at(cfg: ModelConfig, seed: int, step: int, *, batch: int,
             seq: int) -> dict:
    """-> numpy batch dict for ``step`` (tokens/labels or embeds)."""
    rng = np.random.RandomState((seed * 1_000_003 + step) % (2 ** 31 - 1))
    v = cfg.vocab_size
    if cfg.frontend is not None and cfg.frontend.kind == "audio_frames":
        emb = rng.randn(batch, seq, cfg.frontend.input_dim).astype(np.float32)
        labels = rng.randint(0, v, (batch, seq)).astype(np.int32)
        return {"embeds": emb, "labels": labels}
    if cfg.frontend is not None and cfg.frontend.kind == "vit_patches":
        n_p = cfg.frontend.n_positions
        emb = rng.randn(batch, n_p, cfg.frontend.input_dim).astype(np.float32)
        tokens, labels = _lm_tokens(rng, batch, seq, v)
        return {"embeds": emb, "tokens": tokens, "labels": labels}
    tokens, labels = _lm_tokens(rng, batch, seq, v)
    return {"tokens": tokens, "labels": labels}


def _lm_tokens(rng: np.random.RandomState, batch: int, seq: int,
               vocab: int) -> tuple[np.ndarray, np.ndarray]:
    """Order-1 structured stream: next token depends on current (mod mixing),
    giving a learnable low-entropy component plus noise."""
    base = rng.randint(0, vocab, (batch, 1))
    steps = rng.randint(1, 17, (batch, seq))
    noise = (rng.random((batch, seq)) < 0.15) * rng.randint(
        0, vocab, (batch, seq))
    toks = (base + np.cumsum(steps, axis=1)) % vocab
    toks = np.where(noise > 0, noise, toks).astype(np.int32)
    labels = np.roll(toks, -1, axis=1).astype(np.int32)
    labels[:, -1] = toks[:, 0]
    return toks, labels


class SyntheticLMStream:
    """Iterator facade with explicit offset addressing (seek == set step)."""

    def __init__(self, cfg: ModelConfig, *, seed: int, batch: int, seq: int,
                 start_step: int = 0):
        self.cfg = cfg
        self.seed = seed
        self.batch = batch
        self.seq = seq
        self.step = start_step

    def seek(self, step: int) -> None:
        self.step = step

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = batch_at(self.cfg, self.seed, self.step, batch=self.batch,
                     seq=self.seq)
        self.step += 1
        return b
