"""Mixture-of-Experts FFN with top-k routing, shared experts, and
capacity-bounded dispatch.

Port of ``repro/models/moe.py``. Two implementations that agree:

* :func:`moe_ref` — dense reference: every expert computes every token,
  outputs weighted by gates. Exact (dropless); the oracle in tests.
* :func:`moe_capacity` — the path the model runs: per-shard capacity
  buffers filled by one scatter of all k choices (no ``(T, E, C)`` one-hot
  tensor is made; the reference loops over the k choices, the port takes
  them at once, so that a decode step launches a few kernels a layer, not
  a few per choice). It is written **per shard**: it computes experts ``[e0, e0 +
  n_local)`` only and returns a *partial* output, which a sharded caller
  sums over the shards. With ``e0=0, n_local=E`` it is the single-device
  implementation.

Router: softmax over experts in fp32, top-k, gates renormalized over the
selected experts; Switch-style load-balancing auxiliary loss, which stays in
the autograd graph (its gradient reaches the router through the mean
probabilities).

The reference has no Pallas kernel here: the expert products are batched
matrix products and the dispatch is scatters, plain PyTorch on the card as
on the CPU. The reference scatters with ``mode="drop"`` into the row past
the buffer for a choice that overflows its expert or is not local; the
port's buffer has that row (a trash row, added to and never read), and the
dropped token's addend is zero.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import ParamSpec


def moe_spec(cfg: ModelConfig) -> dict:
    e = cfg.moe
    d = cfg.d_model
    spec = {
        # the router stays replicated: it is tiny and read on every shard
        "router": ParamSpec((d, e.n_experts), (None, None),
                            init="normal", scale=0.02),
        "w_gate": ParamSpec((e.n_experts, d, e.d_expert),
                            ("experts", "embed", "expert_ff"), init="lecun"),
        "w_up": ParamSpec((e.n_experts, d, e.d_expert),
                          ("experts", "embed", "expert_ff"), init="lecun"),
        "w_down": ParamSpec((e.n_experts, e.d_expert, d),
                            ("experts", "expert_ff", "embed"), init="lecun"),
    }
    if e.n_shared:
        f = e.n_shared * e.d_expert
        spec["shared"] = {
            "w_gate": ParamSpec((d, f), ("embed", "ff"), init="lecun"),
            "w_up": ParamSpec((d, f), ("embed", "ff"), init="lecun"),
            "w_down": ParamSpec((f, d), ("ff", "embed"), init="lecun"),
        }
    return spec


def router_topk(params: dict, cfg: ModelConfig, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (T, d) -> (gates (T, k) f32, idx (T, k) int64, aux_loss scalar)."""
    e = cfg.moe
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    gates, idx = torch.topk(probs, e.top_k, dim=-1)             # (T, k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    # Switch load-balance loss: E * sum_e f_e * P_e
    t = x.shape[0]
    flat = idx.reshape(-1)    # (bincount would read its max back: a sync)
    counts = torch.zeros((e.n_experts,), dtype=torch.float32,
                         device=x.device).index_add(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=x.device))
    f_e = counts / max(t * e.top_k, 1)
    p_e = probs.mean(0)
    aux = e.n_experts * torch.sum(f_e * p_e)
    return gates, idx, aux


def _expert_ffn(w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """h: (E, C, d) -> (E, C, d), swiglu per expert."""
    g = F.silu(torch.bmm(h, w_gate))
    u = torch.bmm(h, w_up)
    return torch.bmm(g * u, w_down)


def moe_capacity(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                 e0: int = 0, n_local: int | None = None,
                 capacity: int | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bounded top-k MoE over local experts [e0, e0+n_local).

    x: (T, d). Returns (partial_out (T, d), aux_loss). Tokens overflowing an
    expert's capacity are dropped (contribute zero), the standard GShard
    bound; ``capacity_factor`` sets the drop rate."""
    e = cfg.moe
    t = x.shape[0]
    n_local = e.n_experts if n_local is None else n_local
    if capacity is None:
        capacity = max(1, -(-int(e.top_k * t * e.capacity_factor)
                            // e.n_experts))
    gates, idx, aux = router_topk(params, cfg, x)
    slot, ok = dispatch_slots(cfg, idx, e0, n_local, capacity)
    h = dispatch(x, slot, ok, n_local, capacity)
    w_gate, w_up, w_down = params["w_gate"], params["w_up"], params["w_down"]
    if w_gate.shape[0] != n_local:  # the single-device path slices nothing
        w_gate = w_gate[e0:e0 + n_local]
        w_up = w_up[e0:e0 + n_local]
        w_down = w_down[e0:e0 + n_local]
    out_buf = _expert_ffn(w_gate.to(x.dtype), w_up.to(x.dtype),
                          w_down.to(x.dtype), h)
    return combine(out_buf, slot, ok, gates), aux


def dispatch_slots(cfg: ModelConfig, idx: torch.Tensor, e0: int,
                   n_local: int, capacity: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(slot, ok) of every (choice, token) of ``idx`` (T, k), choice-major:
    its row in the local experts' (n_local * capacity) buffer, and whether
    it is kept (its expert local, within capacity); a dropped one's slot is
    the trash row n_local * capacity.

    The position in an expert is counted in the reference's order (choice 0
    of every token, then choice 1, ...): the earlier entries of the same
    expert, in one cumulative sum over the (k T, E) one-hot (made by
    comparison: F.one_hot checks its range on the host, a sync on the card)
    where the reference loops over the k choices."""
    choice = idx.t().reshape(-1)                                # (k T,)
    oh = (choice[:, None] == torch.arange(cfg.moe.n_experts,
                                          device=idx.device)).long()
    pos = ((torch.cumsum(oh, dim=0) - oh) * oh).sum(-1)
    local_e = choice - e0
    ok = (local_e >= 0) & (local_e < n_local) & (pos < capacity)
    slot = torch.where(ok, local_e * capacity + pos,
                       torch.full_like(pos, n_local * capacity))
    return slot, ok


def dispatch(x: torch.Tensor, slot: torch.Tensor, ok: torch.Tensor,
             n_local: int, capacity: int) -> torch.Tensor:
    """x: (T, d) -> (n_local, capacity, d): every kept (choice, token)'s
    row added into its slot (one scatter; the trash row takes the dropped
    ones' zeros and is cut off)."""
    k = slot.shape[0] // x.shape[0]
    trash = n_local * capacity
    xs = x.repeat(k, 1) * ok[:, None].to(x.dtype)
    buf = x.new_zeros((trash + 1, x.shape[1])).index_add(0, slot, xs)
    return buf[:trash].reshape(n_local, capacity, x.shape[1])


def combine(out: torch.Tensor, slot: torch.Tensor, ok: torch.Tensor,
            gates: torch.Tensor) -> torch.Tensor:
    """out: (n_local, capacity, d) -> (T, d): each token's kept choices'
    rows weighted by their gates and summed."""
    trash = out.shape[0] * out.shape[1]
    k = gates.shape[1]
    picked = out.reshape(trash, -1)[torch.clamp_max(slot, trash - 1)]
    w = gates.t().reshape(-1).to(out.dtype) * ok.to(out.dtype)
    return (picked * w[:, None]).reshape(k, -1, out.shape[-1]).sum(0)


def moe_ref(params: dict, cfg: ModelConfig, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense dropless reference: all experts on all tokens. x: (T, d)."""
    e = cfg.moe
    gates, idx, aux = router_topk(params, cfg, x)
    g = F.silu(torch.einsum("td,edf->tef", x, params["w_gate"].to(x.dtype)))
    u = torch.einsum("td,edf->tef", x, params["w_up"].to(x.dtype))
    per_e = torch.einsum("tef,efd->ted", g * u,
                         params["w_down"].to(x.dtype))
    # combine with the top-k gates
    weights = x.new_zeros((x.shape[0], e.n_experts))
    for j in range(e.top_k):
        weights = weights.scatter_add(1, idx[:, j:j + 1],
                                      gates[:, j:j + 1].to(x.dtype))
    y = torch.einsum("ted,te->td", per_e, weights)
    return y, aux


def shared_expert(params: dict, cfg: ModelConfig, x: torch.Tensor
                  ) -> torch.Tensor:
    """Always-on shared expert(s): a plain swiglu FFN (DeepSeek-V3)."""
    p = params["shared"]
    g = F.silu(x @ p["w_gate"].to(x.dtype))
    u = x @ p["w_up"].to(x.dtype)
    return (g * u) @ p["w_down"].to(x.dtype)


def moe_block(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
              impl: str = "capacity", e0: int = 0, n_local: int | None = None,
              dropless: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux). ``impl``: capacity | ref.
    ``dropless`` sets capacity = n_tokens (at decode, where token counts are
    tiny and capacity drops would corrupt generation)."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    capacity = b * s if dropless else None
    if impl == "ref":
        y, aux = moe_ref(params, cfg, flat)
    else:
        y, aux = moe_capacity(params, cfg, flat, e0=e0, n_local=n_local,
                              capacity=capacity)
    if cfg.moe.n_shared:
        y = y + shared_expert(params, cfg, flat)
    return y.reshape(b, s, d), aux
