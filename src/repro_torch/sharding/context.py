"""DistContext — everything the model and step builders need to run a
sharded step: parameter placements, activation constraints, the
expert-parallel MoE island, the vocab-parallel embedding and the
vocab-parallel (Megatron-style) cross-entropy island.

Port of ``repro/sharding/context.py``, its flags included, on
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

Decode. Caches are DTensors placed by
:func:`repro_torch.launch.specs.cache_sharding_tree` (batch over the batch
axes; KV heads over ``model`` where it divides them, else the sequence; MLA's
latent sequence over ``model``). A block's region reaches its cache's
local shard through :meth:`cache_shard` and writes it **in place**; on a
sequence-sharded cache only the rank whose rows hold a new token writes
it. Without ``flash_decode`` a sequence-sharded cache is gathered over
``model`` for the attention (what the reference's GSPMD emits).

The reference's opt-in flags, each an island of its own:

* ``flash_decode`` (:meth:`decode_attention`): sequence-parallel decode
  of a cache cut over ``model`` on its sequence — each ``model`` rank
  attends over its slice of the cache and the slices' outputs merge by
  their log-sum-exps (one max and two sums over ``model``); the cache
  never crosses ranks. On the card the local attention is the
  flash-decode kernel with its log-sum-exp output. A cache cut on its KV
  heads has nothing to merge and decodes as on one device.
* ``chunked_ce`` (:meth:`fused_ce`): the unembedding and the loss scanned
  over token chunks of 512 under non-reentrant checkpointing, so only one
  chunk's (chunk x V/tp) float32 logits are ever live.
* ``fp8_gather``: the expert weights' FSDP gather in ``float8_e4m3fn``
  (:class:`_Fp8Gather`).
* ``weight_stationary`` (:meth:`_moe_ws_island`): the decode MoE gathers
  the tokens over the FSDP axes, not the expert weights.

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
    flags: frozenset = frozenset()      # of FLAGS

    def __post_init__(self):
        unknown = set(self.flags) - FLAGS
        if unknown:
            raise ValueError(f"unknown DistContext flags {sorted(unknown)}")

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

    def reduce_scatter(self, x: torch.Tensor, axes, dim: int
                       ) -> torch.Tensor:
        """Sum over the mesh ``axes`` and keep this rank's shard of
        ``dim`` (the transpose of :meth:`all_gather`: major axis first).
        No autograd."""
        for a in entry_axes(axes):
            if mesh_shape(self.mesh)[a] > 1:
                fc = _funcol()
                scatter = getattr(fc, "reduce_scatter_single", None) \
                    or fc.reduce_scatter_tensor
                x = _wait(scatter(x.contiguous(), "sum", dim,
                                  self.mesh.get_group(a)))
        return x

    def gather_weight(self, w: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """An FSDP weight's gather inside a region: :meth:`all_gather`, or
        under ``fp8_gather`` the same in ``float8_e4m3fn``
        (:class:`_Fp8Gather`)."""
        if self.has("fp8_gather"):
            return _Fp8Gather.apply(w, self, axes, dim)
        return self.all_gather(w, axes, dim)

    def axis_index(self, axis: str) -> int:
        return int(self.mesh.get_local_rank(axis))

    def flat_index(self, axes) -> int:
        """This rank's index among the ranks of the mesh ``axes`` taken
        together (major first: how a dim sharded over them is cut)."""
        i = 0
        for a in entry_axes(axes):
            i = i * mesh_shape(self.mesh)[a] + self.axis_index(a)
        return i

    def batch_rows(self, b: int) -> slice:
        """The rows of a global batch of ``b`` that this rank's batch
        shard holds (:meth:`batch_pspec`)."""
        bax = self.batch_pspec(1, b)[0]
        per = b // axis_size(self.mesh, entry_axes(bax))
        i = self.flat_index(bax)
        return slice(i * per, (i + 1) * per)

    def cache_shard(self, cache: dict) -> "CacheShard":
        """One block's cache (a dict of DTensors, the layers axis indexed
        away) as a region sees it: the local shards (views: writes land in
        the cache) and where the sequence or KV-head dim is cut over
        ``model``."""
        from torch.distributed.tensor import Shard
        first = next(iter(cache.values()))
        tp_dim = None
        for name, pl in zip(self.axis_names, first.placements):
            if name == self.tp_axis and isinstance(pl, Shard):
                tp_dim = pl.dim
        seq = None
        if tp_dim == 1:
            s_global = first.shape[1]
            n = s_global // self.tp_size
            seq = (self.axis_index(self.tp_axis) * n, s_global)
        return CacheShard(self, {k: local(v) for k, v in cache.items()},
                          seq=seq, heads=tp_dim == 2)

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
        if not torch.is_grad_enabled():
            p_leaves = self._gather_flat(p_leaves, in_pl[n_acts:])

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

    def _gather_flat(self, xs: list, targets: list) -> list:
        """Without autograd (serving): the DTensors ``xs`` that reach their
        ``targets`` placements by all-gathers alone (FSDP shards made whole)
        moved there with one all-gather per mesh dim and dtype for all of
        them, in place of one a leaf; the others as they are (the region
        redistributes them)."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        out = list(xs)
        todo = {}          # i -> (local, placements), the gathers pending
        for i, (x, tgt) in enumerate(zip(xs, targets)):
            cur = tuple(x.placements)
            if cur == tuple(tgt):
                continue
            if all(c == t or (isinstance(c, Shard) and isinstance(t, Replicate))
                   for c, t in zip(cur, tgt)):
                todo[i] = (x.to_local(), list(cur))
        names = self.axis_names
        for m in reversed(range(len(names))):          # minor axis first
            need = [i for i, (_, pl) in todo.items()
                    if isinstance(pl[m], Shard)]
            if not need:
                continue
            n = mesh_shape(self.mesh)[names[m]]
            if n == 1:          # the shard is whole already
                for i in need:
                    todo[i][1][m] = Replicate()
                continue
            group = self.mesh.get_group(names[m])
            fc = _funcol()
            gather = getattr(fc, "all_gather_single", None) \
                or fc.all_gather_tensor
            for dt in {todo[i][0].dtype for i in need}:
                part = [i for i in need if todo[i][0].dtype == dt]
                fronts = [todo[i][0].movedim(todo[i][1][m].dim, 0)
                          .contiguous() for i in part]
                flat = torch.cat([f.reshape(-1) for f in fronts])
                got = _wait(gather(flat, 0, group)).view(n, -1)
                off = 0
                for i, f in zip(part, fronts):
                    k = f.numel()
                    whole = got[:, off:off + k].reshape(n * f.shape[0],
                                                        *f.shape[1:])
                    off += k
                    pl = todo[i][1]
                    d, pl[m] = pl[m].dim, Replicate()
                    todo[i] = (whole.movedim(0, d), pl)
        for i, (local, pl) in todo.items():
            out[i] = DTensor.from_local(local, xs[i].device_mesh, tuple(pl),
                                        run_check=False)
        return out

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
        Experts sharded over ``model``. ``decode``: dropless, capacity the
        local token count; with ``weight_stationary``, the tokens are
        gathered, not the weights (:meth:`_moe_ws_island`)."""
        from repro_torch.models.moe import moe_capacity
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
        w_spec = P(expert_sh, d_sh, None)
        wd_spec = P(expert_sh, None, d_sh)   # w_down: (E, f, d)
        routed = {k: params[k] for k in ("router", "w_gate", "w_up",
                                         "w_down")}
        routed_specs = {"router": P(None, None), "w_gate": w_spec,
                        "w_up": w_spec, "w_down": wd_spec}
        if decode and self.has("weight_stationary"):
            y, aux = self._moe_ws_island(
                routed, routed_specs, cfg, x, n_local=n_local,
                expert_sh=expert_sh, d_sh=d_sh, capacity=capacity, bax=bax)
            return self._add_shared(params, cfg, x, y), aux.to_local()

        def island(xl, p):
            w_gate, w_up, w_down = p["w_gate"], p["w_up"], p["w_down"]
            if d_sh is not None:
                w_gate = self.gather_weight(w_gate, d_sh, 1)
                w_up = self.gather_weight(w_up, d_sh, 1)
                w_down = self.gather_weight(w_down, d_sh, 2)
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

        y, aux = self.local(
            island, [x], [P(bax, None, None)], [P(bax, None, None), P()],
            routed, routed_specs)
        return self._add_shared(params, cfg, x, y), aux.to_local()

    def _add_shared(self, params: dict, cfg: ModelConfig, x, y):
        """``y`` plus the shared experts of ``x`` (none: ``y``)."""
        from repro_torch.models.moe import shared_expert
        tp = self.tp_axis
        d = x.shape[-1]
        if cfg.moe.n_shared:
            shared = {"shared": params["shared"]}
            # the shared experts' FFN columns stay sharded as the rules
            # place them; each rank's part is summed over `model`
            split = self.model_spec(shared["shared"]["w_down"])[0] == tp

            def add_shared(yl, hl, p):
                f = shared_expert(p, cfg, hl.reshape(-1, d)).reshape(hl.shape)
                return yl + (self.psum(f, tp) if split else f)

            y = self.dense(add_shared, [y, x], shared,
                           param_specs=tree_map(self.model_spec, shared))
        return y

    # -- weight-stationary decode MoE ------------------------------------------

    def _moe_ws_island(self, routed: dict, routed_specs: dict,
                       cfg: ModelConfig, x, *, n_local: int, expert_sh,
                       d_sh, capacity: int, bax):
        """Decode-time MoE that never gathers expert weights: the island
        all-gathers the (few) *token* rows over the batch axes, routes them
        all, computes with this rank's d-slice of each local expert's
        weights (the slice that its FSDP shard holds), sums the partial
        (E_local, cap, f) products over the FSDP axes, gathers the d-slices
        of the output back and keeps this rank's tokens; one sum over
        ``model`` combines the experts. Dispatch is dropless (capacity at
        least the gathered token count). The reference scatters with
        ``.at[slot].add(mode="drop")``; here the buffer has one trash row
        past the experts' slots, added to and dropped. Returns (y DTensor,
        aux DTensor)."""
        from repro_torch.models.moe import (combine, dispatch, dispatch_slots,
                                            router_topk)
        tp = self.tp_axis
        d = x.shape[-1]
        b_axes = entry_axes(bax)

        def island(xl, p):
            flat = xl.reshape(-1, d)
            xg = self.all_gather(flat, b_axes, 0) if b_axes else flat
            t_g = xg.shape[0]
            gates, idx, aux = router_topk({"router": p["router"]}, cfg, xg)
            e0 = self.axis_index(tp) * n_local if expert_sh is not None \
                else 0
            if d_sh is not None:
                d_local = p["w_gate"].shape[1]
                di = self.flat_index(d_sh)
                x_slice = xg[:, di * d_local:(di + 1) * d_local]
            else:
                x_slice = xg
            cap = max(capacity, t_g)           # decode: dropless
            slot, ok = dispatch_slots(cfg, idx, e0, n_local, cap)
            h = dispatch(x_slice, slot, ok, n_local, cap)
            dt = h.dtype
            g_p = torch.einsum("ecd,edf->ecf", h, p["w_gate"].to(dt))
            u_p = torch.einsum("ecd,edf->ecf", h, p["w_up"].to(dt))
            if d_sh is not None:
                g_p = self.psum(g_p, d_sh)
                u_p = self.psum(u_p, d_sh)
            act = torch.nn.functional.silu(g_p) * u_p
            y = combine(torch.einsum("ecf,efd->ecd", act, p["w_down"].to(dt)),
                        slot, ok, gates)                    # (t_g, d_local)
            if d_sh is not None:
                y = self.all_gather(y, d_sh, 1)                   # (t_g, d)
            if b_axes:                        # this rank's tokens
                t_l = flat.shape[0]
                i = self.flat_index(b_axes)
                y = y[i * t_l:(i + 1) * t_l]
            y = self.psum(y, tp)
            # aux is the same on every rank (the router saw the gathered
            # tokens); averaged over the batch axes as moe_island does
            if b_axes:
                aux = self.psum(aux, bax) / axis_size(self.mesh, b_axes)
            return y.reshape(xl.shape), aux

        return self.local(island, [x], [P(bax, None, None)],
                          [P(bax, None, None), P()], routed, routed_specs)

    # -- flash-decode: sequence-parallel attention over a seq-sharded cache --

    def decode_attention(self, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, k_positions: torch.Tensor,
                         k_valid: torch.Tensor, *, window: int | None = None,
                         kv_chunk: int = 1024, q_offset=0,
                         scale: float | None = None,
                         kernel: bool = True) -> torch.Tensor:
        """Inside a region, on local tensors: q (B, 1, H, Dk) replicated over
        ``model``; k/v (B, S/tp, K, D*) this rank's slice of a cache sharded
        over ``model`` on the sequence, ``k_positions``/``k_valid`` (B, S/tp)
        its rows' global positions and fill. Each rank attends over its
        slice, giving (out, lse), and :func:`flash_decode.merge_lse
        <repro_torch.kernels.flash_decode.merge_lse>` merges the slices over
        ``model`` (one max, two sums). A rank with no valid key (lse = -inf)
        weighs 0.

        The local attention: on CUDA the flash-decode kernel with its
        log-sum-exp output (unbounded: a slice's row is not its position),
        which launches or raises; on the CPU ``chunked_attention`` with its
        running statistics. ``kernel=False`` asks for ``chunked_attention``
        on every device: MLA's absorbed decode (128 query heads on its one
        latent head, keys of 576) is past the kernel's G <= 16 and head dims
        <= 256, as in its single-device decode."""
        from repro_torch.kernels import flash_decode as fd
        from repro_torch.models.attention import chunked_attention
        b = q.shape[0]
        qoff = torch.as_tensor(q_offset, dtype=torch.int32,
                               device=q.device).expand(b)
        if kernel and q.device.type == "cuda":
            kp = torch.where(k_valid, k_positions,
                             torch.full_like(k_positions, -1))
            out, lse = fd.flash_decode(q, k, v, qoff, kp, window=window,
                                       scale=scale, bounded=False,
                                       return_lse=True)
        else:
            out, m, l = chunked_attention(
                q, k, v, q_offset=qoff, k_positions=k_positions,
                k_valid=k_valid, causal=True, window=window,
                kv_chunk=kv_chunk, scale=scale, return_stats=True)
            lse = m + torch.log(l)
        if self.tp_size == 1:
            return out
        tp = self.tp_axis
        return fd.merge_lse(out, lse, lambda t: self.pmax(t, tp),
                            lambda t: self.psum(t, tp)).to(q.dtype)

    # -- chunked fused CE: unembed + loss without materializing logits -------

    def fused_ce(self, hidden, embed_params: dict, cfg: ModelConfig,
                 labels, weights=None, z_weight: float = 1e-4,
                 chunk: int = 512) -> tuple[torch.Tensor, dict]:
        """hidden: (B, S, d) DTensor batch-sharded (``forward(...,
        return_hidden=True)``); the unembedding (``embed_params``: the tied
        table or ``unembed``) vocab-sharded over ``model``. Each rank
        gathers its vocab shard of the table over the FSDP axes (the
        gather's backward reduce-scatters), then scans its tokens in chunks
        of ``chunk``, each chunk under non-reentrant
        ``torch.utils.checkpoint``: the chunk's (chunk x V/tp) float32
        logits (:func:`repro_torch.models.layers.unembed`, as the
        single-device loss computes them), a detached max over ``model`` as
        the stabilizer, ``lse = m + log(psum(sum exp(lg - m)))`` and the
        label's logit summed over ``model``. Only one chunk's logits are
        live, in the forward and in the backward. Returns (loss, metrics)
        as :meth:`vocab_parallel_loss`. ``cfg`` stands for the reference's
        ``tie_embeddings`` (the table's kind and the logits' dtype).
        Raises where ``model`` does not divide the vocabulary."""
        from torch.utils.checkpoint import checkpoint
        from repro_torch.models.layers import unembed
        tp, fsdp = self.tp_axis, self.fsdp_axes
        b, s, d = hidden.shape
        tied = cfg.tie_embeddings
        table = embed_params["embedding"] if tied else embed_params["unembed"]
        v = table.shape[0 if tied else 1]
        if v % self.tp_size != 0:
            raise ValueError("fused_ce requires vocab divisible by tp")
        bax = self.batch_pspec(3, b)[0]
        if weights is None:
            weights = _ones_like_batch(labels)
        d_sh = fsdp if d % axis_size(self.mesh, fsdp) == 0 else None
        if d_sh is not None and len(d_sh) == 1:
            d_sh = d_sh[0]

        def body(hc, lc, wc, wl, v0):
            key = "embedding" if tied else "unembed"
            lg = unembed({key: wl}, cfg, hc[None])[0].float()
            v_local = lg.shape[-1]
            m = self.pmax(lg.amax(-1), tp)          # stabilizer only
            lse = m + torch.log(self.psum(
                torch.exp(lg - m[:, None]).sum(-1), tp))
            lbi = lc.long()
            hit = (lbi >= v0) & (lbi < v0 + v_local)
            ll = torch.gather(lg, -1, (lbi - v0).clamp(0, v_local - 1)
                              [:, None])[:, 0]
            ll = self.psum(torch.where(hit, ll, torch.zeros_like(ll)), tp)
            return ((lse - ll) * wc).sum(), (lse.square() * wc).sum()

        def island(h, lb, wt, p):
            wl = p["w"]
            if d_sh is not None:
                wl = self.all_gather(wl, d_sh, 1 if tied else 0)
            v0 = self.axis_index(tp) * wl.shape[0 if tied else 1]
            hb = h.reshape(-1, d)
            lbf = lb.reshape(-1)
            wtf = wt.reshape(-1).float()
            t = hb.shape[0]
            cc = max(1, min(chunk, t))
            ce_sum = z_sum = torch.zeros((), dtype=torch.float32,
                                         device=hb.device)
            for i in range(0, t, cc):
                ce_c, z_c = checkpoint(body, hb[i:i + cc], lbf[i:i + cc],
                                       wtf[i:i + cc], wl, v0,
                                       use_reentrant=False)
                ce_sum = ce_sum + ce_c
                z_sum = z_sum + z_c
            denom = torch.clamp_min(self.psum(wtf.sum(), bax), 1.0)
            return (self.psum(ce_sum, bax) / denom,
                    self.psum(z_sum, bax) / denom, denom)

        w_spec = P(tp, d_sh) if tied else P(d_sh, tp)
        ce, z, denom = self.local(
            island, [hidden, labels, weights],
            [P(bax, None, None), P(bax, None), P(bax, None)],
            [P(), P(), P()], {"w": table}, {"w": w_spec})
        ce, z, denom = ce.to_local(), z.to_local(), denom.to_local()
        loss = ce + z_weight * z
        return loss, {"ce": ce, "z_loss": z, "tokens": denom}

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


@dataclass(frozen=True)
class CacheShard:
    """One block's decode cache inside its sharded region: ``local`` the
    rank's shards (views of the cache DTensors' storage, written in place),
    ``seq`` (first global row, global rows) when the sequence dim is cut
    over ``model``, ``heads`` when the KV-head dim is."""
    dist: DistContext
    local: dict
    seq: tuple[int, int] | None = None
    heads: bool = False

    def has(self, flag: str) -> bool:
        return self.dist.has(flag)

    @property
    def rows(self) -> tuple[int, int]:
        """(first global row, global rows) of this rank's sequence slice."""
        if self.seq is None:
            n = next(iter(self.local.values())).shape[1]
            return 0, n
        return self.seq

    def gather(self, *ts: torch.Tensor) -> tuple:
        """Sequence-sharded cache tensors (B, S/tp, ..., D_i) whole (B, S,
        ..., D_i), in one all-gather over ``model`` (joined on their last
        dim); any other as they are."""
        if self.seq is None:
            return ts
        whole = self.dist.all_gather(torch.cat(ts, -1), self.dist.tp_axis, 1)
        return tuple(torch.split(whole, [t.shape[-1] for t in ts], -1))


def write_rows(c: torch.Tensor, slots: torch.Tensor, val: torch.Tensor,
               r0: int) -> None:
    """``c[b, slots[b, j] - r0] = val[b, j]`` for the slots that fall in
    this rank's rows [r0, r0 + c.shape[1]) of a sequence-sharded cache;
    the others belong to other ranks. ``slots``: (B, T) global rows."""
    loc = slots.long() - r0
    ok = (loc >= 0) & (loc < c.shape[1])
    rows = torch.arange(c.shape[0], device=c.device)[:, None].expand_as(loc)
    c[rows[ok], loc[ok]] = val[ok].to(c.dtype)


class _Fp8Gather(torch.autograd.Function):
    """The expert weights' FSDP gather under ``fp8_gather``: the local
    shard cast to ``float8_e4m3fn``, all-gathered as its bytes (a
    ``uint8`` view: neither gloo nor NCCL is sure to gather float8), cast
    back to the weight's dtype. The forward is the reference's.

    The backward differs from the reference's in one place. The
    reference's gradient is quantised at the same points (the cast's
    cotangent is rounded to e4m3) and its transposed gather is a
    reduce-scatter *in float8*; neither backend sums float8, so here the
    cotangent is rounded to e4m3 and back, then reduce-scattered in the
    weight's dtype (the sums are not rounded to e4m3)."""

    @staticmethod
    def forward(ctx, w, dist, axes, dim):
        ctx.dist, ctx.axes, ctx.dim = dist, axes, dim
        w8 = w.to(torch.float8_e4m3fn).view(torch.uint8)
        fc = _funcol()
        gather = getattr(fc, "all_gather_single", None) \
            or fc.all_gather_tensor
        for a in reversed(entry_axes(axes)):    # minor axis first
            if mesh_shape(dist.mesh)[a] > 1:
                w8 = _wait(gather(w8.contiguous(), dim,
                                  dist.mesh.get_group(a)))
        return w8.view(torch.float8_e4m3fn).to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.float8_e4m3fn).to(g.dtype)
        return ctx.dist.reduce_scatter(g, ctx.axes, ctx.dim), None, None, \
            None
