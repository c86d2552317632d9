"""DistContext — everything the model and step builders need to run a
sharded step: parameter placements, activation constraints, the
expert-parallel MoE island, the vocab-parallel embedding and the
vocab-parallel (Megatron-style) cross-entropy island.

Port of ``repro/sharding/context.py`` at its default flags, on
``torch.distributed``. The reference runs GSPMD (pjit +
``with_sharding_constraint``) as the global strategy with explicit
``shard_map`` islands; the port's counterparts:

* **Placement.** Every leaf of the train state is a DTensor on the mesh,
  placed by :mod:`repro_torch.sharding.rules`: FSDP/ZeRO-3 over the batch
  axes (``pod``, ``data``) and tensor/expert sharding over ``model``, so
  each rank holds only its shards of parameters, gradients and AdamW state.
* **Regions.** DTensor's own op-by-op sharding propagation is not the
  engine (on a 3-d mesh its strategy search for one einsum takes tens of
  seconds): every computation runs as a ``local_map`` region on the
  rank's local tensors, with declared placements. A block's region
  gathers its weights over the FSDP axes on entry (DTensor
  redistribution); the autograd graph keeps the gathered copies for the
  backward, as the reference's residuals do, and under ``remat="full"``
  the backward gathers them again. Attention heads and MLP columns that
  the rules shard over ``model`` stay sharded there (Megatron's split:
  each rank's heads or columns, one all-reduce of the layer's output);
  the SSD, RG-LRU and MLA mixers gather their weights over ``model`` too.
  Activations between regions are batch-sharded over the batch axes and
  replicated over ``model``. The hand kernels (flash attention, the SSD
  scan) launch inside the regions on the rank's local q/k/v or x/dt/B/C.
* **MoE island** (``moe_island``): experts live on ``model``; every rank
  routes all of its data shard's tokens through
  :func:`repro_torch.models.moe.moe_capacity` for its local experts, and one
  all-reduce over ``model`` combines. Expert weights are FSDP-gathered
  inside the island by an all-gather whose backward is a reduce-scatter.
* **Vocab-parallel embedding** (``embed``): each ``model`` rank looks up the
  tokens of its vocab shard and one all-reduce combines (the reference's
  GSPMD gather at ``repro/models/layers.py:96``).
* **CE island** (``vocab_parallel_loss``): logits stay vocab-sharded;
  each shard's log-sum-exp and label logit are all-reduced, so the full
  (B, S, V) logits never exist on one rank.

Gradients. The backward runs each rank's program with the true transpose
of every collective (all-reduce for an all-reduce, reduce-scatter for an
all-gather), from a loss seeded with ``1 / n_devices`` on every rank
(:attr:`grad_seed`); a parameter entering a region replicated over some
mesh dims gets a *partial* gradient there, which the redistribution back
to its own placement sums (reduce-scatter or all-reduce). Every rank holds
the same loss, so the sum over ranks of the seeded program is the loss:
the gradients are exact, whatever the mesh replicates.

The reference's opt-in flags (``flash_decode``, ``chunked_ce``,
``fp8_gather``, ``weight_stationary``) and the members they gate
(``decode_attention``, ``fused_ce``) raise ``NotImplementedError``: a
context with any flag is refused when it is made. They come with the last
sharded slice (``ROADMAP.md`` Queue 1, item 8).

The pure members (``fsdp_axes``, ``batch_axes``, ``tp_size``,
``n_devices``, ``batch_pspec``, ``param_shardings``) read the mesh only
through its axis name → size mapping, so a plain dict serves as the mesh
for them (:func:`repro_torch.launch.mesh.mesh_axes`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.tree import leaves, tree_map, unflatten_as

from .rules import (P, PartitionSpec, axis_size, batch_spec, entry_axes,
                    mesh_shape, to_placements, tree_shardings)

_NEXT = "comes with the last sharded slice: ROADMAP.md Queue 1, item 8"
# the reference's opt-in optimizations beyond the baseline
FLAGS = frozenset({"flash_decode", "chunked_ce", "fp8_gather",
                   "weight_stationary"})


def _funcol():
    import torch.distributed._functional_collectives as funcol
    return funcol


def _wait(x: torch.Tensor) -> torch.Tensor:
    """A functional collective's result as a plain tensor (waited on)."""
    return x.wait() if hasattr(x, "wait") else x


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local(x: Any) -> Any:
    """The rank's local shard of a DTensor; anything else as it is."""
    return x.to_local() if is_dtensor(x) else x


@dataclass(frozen=True)
class DistContext:
    mesh: Any                   # DeviceMesh (or an axis name -> size map)
    tp_axis: str = "model"
    flags: frozenset = frozenset()      # of FLAGS; none is ported yet

    def __post_init__(self):
        unknown = set(self.flags) - FLAGS
        if unknown:
            raise ValueError(f"unknown DistContext flags {sorted(unknown)}")
        if self.flags:
            raise NotImplementedError(
                f"the flag-gated islands {sorted(self.flags)} {_NEXT}")

    def has(self, flag: str) -> bool:
        return flag in self.flags

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(mesh_shape(self.mesh))

    @property
    def fsdp_axes(self) -> tuple[str, ...]:
        return tuple(n for n in self.axis_names if n != self.tp_axis)

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return self.fsdp_axes

    @property
    def tp_size(self) -> int:
        return int(mesh_shape(self.mesh)[self.tp_axis])

    @property
    def n_devices(self) -> int:
        return axis_size(self.mesh, self.axis_names)

    @property
    def grad_seed(self) -> float:
        """What every rank seeds its backward with (see the module's
        note): the loss's share on each rank."""
        return 1.0 / self.n_devices

    # -- spec helpers ---------------------------------------------------------

    def placements(self, spec: Sequence) -> tuple:
        return to_placements(spec, self.axis_names)

    def batch_pspec(self, ndim: int, batch_size: int) -> PartitionSpec:
        return batch_spec(ndim, self.batch_axes, batch_size, self.mesh)

    def param_shardings(self, shapes_tree: Any, axes_tree: Any) -> Any:
        return tree_shardings(shapes_tree, axes_tree, self.mesh,
                              fsdp_axes=self.fsdp_axes, tp_axis=self.tp_axis)

    def _act_spec(self, x) -> PartitionSpec:
        return self.batch_pspec(x.dim(), x.shape[0])

    # -- placing and gathering trees ------------------------------------------

    def distribute(self, tree: Any, specs: Any) -> Any:
        """Every leaf of ``tree`` (the same full tensor on every rank) as a
        DTensor placed by the matching PartitionSpec of ``specs``; each
        rank keeps only its shard."""
        from torch.distributed.tensor import distribute_tensor
        flat = leaves(tree)
        flat_s = [s for s in _spec_leaves(specs)]
        assert len(flat) == len(flat_s), (len(flat), len(flat_s))
        return unflatten_as(tree, [
            distribute_tensor(t, self.mesh, self.placements(s),
                              src_data_rank=None)
            for t, s in zip(flat, flat_s)])

    def shard_batch(self, batch: dict) -> dict:
        """A global batch (the same on every rank) as DTensors sharded over
        the batch axes (:meth:`batch_pspec`)."""
        from torch.distributed.tensor import distribute_tensor
        return {k: distribute_tensor(v, self.mesh,
                                     self.placements(self._act_spec(v)),
                                     src_data_rank=None)
                for k, v in batch.items()}

    @staticmethod
    def gather(tree: Any) -> Any:
        """Every DTensor leaf as its full tensor on every rank."""
        return tree_map(lambda x: x.full_tensor() if is_dtensor(x) else x,
                        tree)

    @staticmethod
    def map_local(fn: Callable, tree: Any, *rest: Any) -> Any:
        """``fn`` over the local shards of matching leaves; the results
        keep the first tree's placements (an elementwise map)."""
        return tree_map(lambda x, *ys: _like(x, fn(local(x), *map(local, ys))),
                        tree, *rest)

    @staticmethod
    def index(tree: Any, i: int) -> Any:
        """Slice ``i`` of the leading (layers) axis of every DTensor leaf,
        taken on the local shards (the layers axis is never sharded)."""
        from torch.distributed.tensor import DTensor, Shard

        def one(x):
            pl = []
            for p in x.placements:
                if isinstance(p, Shard):
                    assert p.dim > 0, "the layers axis is never sharded"
                    p = Shard(p.dim - 1)
                pl.append(p)
            return DTensor.from_local(x.to_local()[i], x.device_mesh, pl,
                                      run_check=False)
        return tree_map(one, tree)

    # -- collectives inside a region (true transposes: see the module) --------

    def _groups(self, axes) -> list:
        return [self.mesh.get_group(a) for a in entry_axes(axes)
                if mesh_shape(self.mesh)[a] > 1]

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum over the mesh ``axes`` (an all-reduce per axis; its backward
        is the all-reduce of the cotangent)."""
        for g in self._groups(axes):
            x = _wait(_funcol().all_reduce(x, "sum", g))
        return x

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Max over the mesh ``axes``; no gradient."""
        x = x.detach()
        for g in self._groups(axes):
            x = _wait(_funcol().all_reduce(x, "max", g))
        return x

    def all_gather(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """Concatenate the shards of ``dim`` over the mesh ``axes`` (major
        first); the backward reduce-scatters."""
        fc = _funcol()
        gather = getattr(fc, "all_gather_single_autograd", None) \
            or fc.all_gather_tensor_autograd
        for a in reversed(entry_axes(axes)):   # minor axis first
            if mesh_shape(self.mesh)[a] > 1:
                x = _wait(gather(x.contiguous(), dim, self.mesh.get_group(a)))
        return x

    def axis_index(self, axis: str) -> int:
        return int(self.mesh.get_local_rank(axis))

    # -- regions ------------------------------------------------------------

    def local(self, fn: Callable, acts: Sequence, act_specs: Sequence,
              out_specs: Sequence, params: Any = None,
              param_specs: Any = None) -> Any:
        """Run ``fn(*local_acts, local_params)`` as a ``local_map`` region.

        ``acts``: DTensors moved to ``act_specs``; their gradients pass
        through per rank.
        ``params``: a tree of DTensors moved to ``param_specs`` (a matching
        tree of PartitionSpecs, or one spec for every leaf); a leaf
        replicated over a mesh dim gets a partial gradient there. ``fn``
        gets the params as the same tree of local tensors.
        ``out_specs``: one PartitionSpec per tensor output."""
        from torch.distributed.tensor import Partial, Replicate
        from torch.distributed.tensor.experimental import local_map
        p_leaves = leaves(params) if params is not None else []
        p_specs = [param_specs] * len(p_leaves) \
            if isinstance(param_specs, PartitionSpec) \
            else _spec_leaves(param_specs)
        assert len(p_specs) == len(p_leaves)
        in_pl, in_grad = [], []
        for s in act_specs:
            in_pl.append(self.placements(s))
            in_grad.append(self.placements(s))
        for s in p_specs:
            pl = self.placements(s)
            in_pl.append(pl)
            in_grad.append(tuple(Partial() if isinstance(q, Replicate)
                                 else q for q in pl))
        n_acts = len(acts)

        def body(*flat):
            p = unflatten_as(params, list(flat[n_acts:])) \
                if params is not None else None
            return fn(*flat[:n_acts], p)

        # local_map reads a tuple as one entry per output, a list as the
        # placements of its one output
        outs = tuple(list(self.placements(s)) for s in out_specs)
        return local_map(body, out_placements=outs if len(outs) > 1
                         else outs[0], in_placements=tuple(in_pl),
                         in_grad_placements=tuple(in_grad),
                         device_mesh=self.mesh, redistribute_inputs=True
                         )(*acts, *p_leaves)

    def dense(self, fn: Callable, acts: Sequence, params: Any, *,
              n_out: int = 1, param_specs: Any = P()):
        """A dense region: ``fn(*acts_local, params_local)`` on the rank's
        batch shard, every parameter gathered whole unless ``param_specs``
        keeps a dim sharded; ``n_out`` outputs, each batch-sharded like the
        first of ``acts``."""
        specs = [self._act_spec(a) for a in acts]
        return self.local(fn, acts, specs, [specs[0]] * n_out, params,
                          param_specs)

    def model_spec(self, x) -> PartitionSpec:
        """The placement of DTensor ``x`` over ``model`` alone: the dims it
        is sharded on over the tensor-parallel axis, every other mesh axis
        gathered (a weight as a tensor-parallel region takes it)."""
        from torch.distributed.tensor import Shard
        entries: list = [None] * x.dim()
        for name, pl in zip(self.axis_names, x.placements):
            if name == self.tp_axis and isinstance(pl, Shard):
                entries[pl.dim] = name
        return P(*entries)

    # -- activation constraint ---------------------------------------------

    def constrain_activation(self, x):
        """(B, S, d) activations: batch over data axes, replicated
        elsewhere."""
        pl = self.placements(self._act_spec(x))
        return x if tuple(x.placements) == pl else x.redistribute(
            self.mesh, pl)

    # -- vocab-parallel embedding ---------------------------------------------

    def embed(self, table, cfg: ModelConfig, tokens):
        """(V, d) table -> (B, S, d) rows of ``tokens`` in the working
        dtype, scaled as :func:`repro_torch.models.layers.embed` does. A
        table sharded over ``model`` on the vocab: each rank looks up the
        tokens of its shard, zeros elsewhere, one all-reduce combines."""
        from repro_torch.models.layers import embed as embed_rows
        tp = self.tp_axis
        vocab_sh = table.shape[0] % self.tp_size == 0
        bspec = self.batch_pspec(2, tokens.shape[0])

        def island(tl, tbl):
            if not vocab_sh:
                return embed_rows({"embedding": tbl}, cfg, tl)
            v_local = tbl.shape[0]
            v0 = self.axis_index(tp) * v_local
            t = tl.long() - v0
            hit = (t >= 0) & (t < v_local)
            rows = tbl.to(torch_dtype(cfg.dtype))[t.clamp(0, v_local - 1)]
            x = self.psum(rows * hit[..., None].to(rows.dtype), tp)
            if cfg.scale_embeddings:
                x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                                     device=x.device)
            return x

        return self.local(island, [tokens], [bspec],
                          [P(bspec[0], None, None)], table,
                          P(tp if vocab_sh else None, None))

    # -- MoE island -----------------------------------------------------------

    def moe_island(self, params: dict, cfg: ModelConfig, x, *,
                   decode: bool = False):
        """x: (B, S, d) DTensor -> (y DTensor, aux float32 scalar).
        Experts sharded over ``model``."""
        from repro_torch.models.moe import moe_capacity, shared_expert
        e = cfg.moe
        tp, fsdp = self.tp_axis, self.fsdp_axes
        if e.n_experts % self.tp_size == 0:
            n_local = e.n_experts // self.tp_size
            expert_sh = tp
        else:  # tiny smoke meshes: replicate experts
            n_local = e.n_experts
            expert_sh = None
        b, s, d = x.shape
        bspec = self.batch_pspec(3, b)
        bax = bspec[0]
        # expert weights: (E, d, f) — E over model, d over fsdp (if divisible)
        d_sh = fsdp if d % axis_size(self.mesh, fsdp) == 0 else None
        if d_sh is not None and len(d_sh) == 1:
            d_sh = d_sh[0]
        tokens_local = (b * s) // axis_size(self.mesh, entry_axes(bax))
        if decode:
            capacity = tokens_local
        else:
            capacity = max(1, -(-int(e.top_k * tokens_local *
                                     e.capacity_factor) // e.n_experts))

        def island(xl, p):
            w_gate, w_up, w_down = p["w_gate"], p["w_up"], p["w_down"]
            if d_sh is not None:
                w_gate = self.all_gather(w_gate, d_sh, 1)
                w_up = self.all_gather(w_up, d_sh, 1)
                w_down = self.all_gather(w_down, d_sh, 2)
            e0 = self.axis_index(tp) * n_local if expert_sh is not None \
                else 0
            y, aux = moe_capacity(
                {"router": p["router"], "w_gate": w_gate, "w_up": w_up,
                 "w_down": w_down}, cfg, xl.reshape(-1, d),
                e0=e0, n_local=n_local, capacity=capacity)
            y = self.psum(y, tp)
            # aux is invariant over `model` (same router, same tokens on
            # every tp rank); mean over exactly the axes the batch is
            # sharded on.
            if entry_axes(bax):
                aux = self.psum(aux, bax) / axis_size(self.mesh,
                                                      entry_axes(bax))
            return y.reshape(xl.shape), aux

        w_spec = P(expert_sh, d_sh, None)
        wd_spec = P(expert_sh, None, d_sh)   # w_down: (E, f, d)
        routed = {k: params[k] for k in ("router", "w_gate", "w_up",
                                         "w_down")}
        y, aux = self.local(
            island, [x], [P(bax, None, None)], [P(bax, None, None), P()],
            routed, {"router": P(None, None), "w_gate": w_spec,
                     "w_up": w_spec, "w_down": wd_spec})
        if e.n_shared:
            shared = {"shared": params["shared"]}
            # the shared experts' FFN columns stay sharded as the rules
            # place them; each rank's part is summed over `model`
            split = self.model_spec(shared["shared"]["w_down"])[0] == tp

            def add_shared(yl, hl, p):
                f = shared_expert(p, cfg, hl.reshape(-1, d)).reshape(hl.shape)
                return yl + (self.psum(f, tp) if split else f)

            y = self.dense(add_shared, [y, x], shared,
                           param_specs=tree_map(self.model_spec, shared))
        return y, aux.to_local()

    # -- flag-gated islands of the next slice ---------------------------------

    def decode_attention(self, *args, **kwargs):
        raise NotImplementedError(
            f"sequence-parallel decode attention (flash_decode) {_NEXT}")

    def fused_ce(self, *args, **kwargs):
        raise NotImplementedError(f"the chunked fused CE (chunked_ce) {_NEXT}")

    # -- vocab-parallel CE ---------------------------------------------------

    def vocab_parallel_loss(self, logits, labels, weights=None,
                            z_weight: float = 1e-4
                            ) -> tuple[torch.Tensor, dict]:
        """logits: (B, S, V) DTensor vocab-sharded over ``model``; labels:
        (B, S). Returns (loss, metrics), float32 scalars equal on every
        rank. A vocab the ``model`` axis does not divide arrives
        replicated and takes the same island without the vocab sums."""
        b, s, v = logits.shape
        tp = self.tp_axis
        vocab_sh = v % self.tp_size == 0
        bspec = self.batch_pspec(3, b)
        bax = bspec[0]
        if weights is None:
            weights = _ones_like_batch(labels)

        def island(lg, lb, wt, _):
            v_local = lg.shape[-1]
            v0 = self.axis_index(tp) * v_local if vocab_sh else 0
            lg = lg.float()
            # lm_loss's logsumexp on the shard (so that one shard is the
            # single-device loss bit for bit); the shards' combined through
            # their max, a stabilizer only (no gradient)
            lse = torch.logsumexp(lg, dim=-1)
            if vocab_sh and self.tp_size > 1:
                m = self.pmax(lse, tp)
                lse = m + torch.log(self.psum(torch.exp(lse - m), tp))
            lbi = lb.long()
            idx_local = (lbi - v0).clamp(0, v_local - 1)
            hit = (lbi >= v0) & (lbi < v0 + v_local)
            ll_local = torch.gather(lg, -1, idx_local[..., None])[..., 0]
            ll = torch.where(hit, ll_local, torch.zeros_like(ll_local))
            if vocab_sh:
                ll = self.psum(ll, tp)
            nll = lse - ll
            wt = wt.float()
            denom = torch.clamp_min(self.psum(wt.sum(), bax), 1.0)
            ce = self.psum((nll * wt).sum(), bax) / denom
            z = self.psum((lse.square() * wt).sum(), bax) / denom
            return ce, z, denom

        ce, z, denom = self.local(
            island, [logits, labels, weights],
            [P(bax, None, tp if vocab_sh else None), P(bax, None),
             P(bax, None)], [P(), P(), P()])
        ce, z, denom = ce.to_local(), z.to_local(), denom.to_local()
        loss = ce + z_weight * z
        return loss, {"ce": ce, "z_loss": z, "tokens": denom}

    # -- the optimizer on the shards ------------------------------------------

    def global_norm(self, grads: Any) -> torch.Tensor:
        """sqrt of the sum of squares of every gradient element, counted
        once: each rank sums its shards, a leaf replicated over mesh dims
        divided by their size, and one all-reduce adds the ranks."""
        from torch.distributed.tensor import Replicate
        total = None
        for g in leaves(grads):
            sq = local(g).float().square().sum()
            if is_dtensor(g):
                reps = 1
                for pl, n in zip(g.placements, g.device_mesh.shape):
                    if isinstance(pl, Replicate):
                        reps *= n
                sq = sq / reps
            total = sq if total is None else total + sq
        if self.n_devices > 1:
            import torch.distributed as tdist
            total = total.clone()
            tdist.all_reduce(total)
        return torch.sqrt(total)

    def adamw_update(self, params: Any, grads: Any, state: dict, ocfg,
                     lr: torch.Tensor) -> tuple[Any, dict, dict]:
        """:func:`repro_torch.optim.adamw_update` on DTensor trees: each
        leaf's elementwise update on its local shards, the global norm by
        :meth:`global_norm`. A factored second moment's row and column
        means reduce over dims that may be sharded: those leaves update as
        DTensors and return to their own placements."""
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch.optim.adamw import adamw_update, update_leaf

        def leaf(p, g, m, v, w, **kw):
            kw = {k: local(t) for k, t in kw.items()}
            like = (p, m, v, w)
            if isinstance(v, dict) and "row" in v:
                with implicit_replication():
                    out = update_leaf(p, g, m, v, w, **kw)
                return tree_map(
                    lambda o, ref: o.redistribute(ref.device_mesh,
                                                  ref.placements)
                    .to(ref.dtype), out, like)
            out = update_leaf(*(tree_map(local, t) for t in (p, g, m, v, w)),
                              **kw)
            return tree_map(_like, like, out)

        return adamw_update(params, grads, state, ocfg, lr,
                            grad_norm=self.global_norm(grads),
                            leaf_fn=leaf)


def _spec_leaves(specs: Any) -> list:
    """The PartitionSpecs of a tree of them, in flattening order (a spec
    is a tuple, so the tree walk must stop at it)."""
    if isinstance(specs, PartitionSpec):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    from repro_torch.tree import _NODES
    spec = _NODES.get(type(specs))
    if spec is not None:
        return [s for c in spec[0](specs) for s in _spec_leaves(c)]
    if isinstance(specs, (list, tuple)):
        return [s for c in specs for s in _spec_leaves(c)]
    if specs is None:
        return []
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


def _like(ref, x: torch.Tensor):
    """``x``, a local shard, as a DTensor placed like ``ref`` (``x`` as
    it is when ``ref`` is not a DTensor)."""
    if not is_dtensor(ref):
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, ref.device_mesh, ref.placements,
                              run_check=False)


def _ones_like_batch(labels):
    return _like(labels, torch.ones(local(labels).shape, dtype=torch.float32,
                                    device=local(labels).device))
