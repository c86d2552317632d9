"""LM losses. Port of ``repro/train/loss.py``: the plain path, per-token
log-probs with a gather (the vocab-parallel path of a sharded step is
:meth:`repro_torch.sharding.DistContext.vocab_parallel_loss`)."""
from __future__ import annotations

import torch


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            weights: torch.Tensor | None = None,
            z_weight: float = 1e-4) -> tuple[torch.Tensor, dict]:
    """logits: (B, S, V) (any float dtype, upcast here); labels: (B, S) int.
    ``weights``: optional (B, S) mask. Returns (scalar loss, metrics)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if weights is None:
        weights = torch.ones_like(nll)
    weights = weights.float()
    denom = torch.clamp_min(weights.sum(), 1.0)
    ce = (nll * weights).sum() / denom
    z = (lse.square() * weights).sum() / denom
    loss = ce + z_weight * z
    return loss, {"ce": ce, "z_loss": z, "tokens": weights.sum()}
