"""The ranks of the port's sharded tests (``tests/test_torch_sharded_step.py``,
``test_torch_sharded_serve.py``, ``test_torch_dist_flags.py``): one process
per rank on the CPU, gloo over a ``FileStore``, no jax.

:func:`spawn_world` starts a world, each rank runs :func:`_rank` over the
cases the parent wrote with ``torch.save``, each by the runner of its
``kind`` (default "train"; ``flags`` are the ``DistContext``'s, ``cfg``
changes the smoke config), and rank 0 writes back each case's result:

* "train" (a train state, a batch, the optimizer config and the step's
  knobs; ``batches`` takes one step on each): the last step's metrics,
  every step's loss, the gathered params and optimizer state after the
  last step, and for every rank the leaves whose local shard shape is not
  the one the sharding rules give, and the elements it holds;
* "serve" (params, a prompt and its embeds, ``max_len``, ``new``; paged:
  ``page_size`` and ``pages``): every step's logits and the greedy tokens
  (:func:`_serve_case`);
* "island" (q, k, v, positions): ``decode_attention``'s output;
* "fused_ce" (hidden states, labels, the embedding's params, ``chunk``):
  ``fused_ce``'s loss, metrics and gathered gradients;
* "fp8_gather" (a weight ``w``, ``dim``, one cotangent a rank ``g``): the
  gathered weight and the gradient of each rank's shard.
"""
import os
import sys
import traceback

import torch
import torch.multiprocessing as mp

def _train_case(name, case, rank, world, axes, mesh, results):
    """Train steps on the sharded state; rank 0 records metrics, losses,
    gathered state and every rank's shard shapes."""
    import torch.distributed as tdist
    from repro_torch import configs
    from repro_torch.optim import OptimizerConfig
    from repro_torch.sharding import DistContext, state_axes
    from repro_torch.sharding.rules import resolve_spec
    from repro_torch.train import (make_train_step, shard_train_state,
                                   train_state_shapes)
    from repro_torch.tree import flatten_up_to, leaves, paths

    dist = DistContext(mesh, flags=frozenset(case.get("flags", ())))
    cfg = configs.smoke_config(case["arch"]).with_(**case.get("cfg", {}))
    ocfg = OptimizerConfig(**case["opt"])
    state = shard_train_state(case["state"], cfg, ocfg, dist)
    # every rank's local shard shapes against the rules
    shapes = train_state_shapes(cfg, ocfg)
    want = []
    for (p, t), ax in zip(paths(shapes), flatten_up_to(
            shapes, state_axes(cfg, ocfg))):
        spec = resolve_spec(tuple(ax), tuple(t.shape), mesh,
                            fsdp_axes=dist.fsdp_axes) \
            if ax is not None else ()
        shp = list(t.shape)
        for i, entry in enumerate(spec):
            for a in ((entry,) if isinstance(entry, str)
                      else (entry or ())):
                shp[i] //= axes[a]
        want.append((p, tuple(shp)))
    got = [tuple(x.to_local().shape) for x in leaves(state)]
    per_rank = [None] * world
    tdist.all_gather_object(per_rank, (
        [p for (p, w), g in zip(want, got) if w != g],
        sum(x.to_local().numel() for x in leaves(state))))
    step = make_train_step(cfg, ocfg, dist=dist, **case["knobs"])
    losses = []
    for batch in case.get("batches", [case.get("batch")]):
        state, metrics = step(state, dist.shard_batch(batch))
        losses.append(float(metrics["loss"]))
    full = DistContext.gather((state.params, state.opt))
    if rank == 0:
        results[name] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "losses": losses,
            "params": full[0], "opt": full[1],
            # per rank: the leaves whose local shape is not the
            # rules' shard shape, and the elements it holds
            "ranks": per_rank,
            "want_resident": sum(
                int(torch.Size(w).numel()) for _, w in want),
            "whole": sum(x.numel() for x in leaves(state)),
        }


def _serve_case(name, case, rank, world, axes, mesh, results):
    """The sharded serving path: params placed by the rules, caches by
    ``cache_sharding_tree``; a prefill of ``case["prompt"]`` (plus its
    ``embeds``) then ``case["new"]`` greedy decode steps (an encoder takes
    the prefill alone). A paged case (``case["paged"]``) feeds the prompt a
    token a step through the paged serve step instead. Rank 0 records
    every step's logits (B, V) and the generated tokens."""
    from repro_torch import configs
    from repro_torch.launch.specs import cache_sharding_tree
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.params import param_shapes
    from repro_torch.models.transformer import (init_caches,
                                                init_paged_caches,
                                                model_spec)
    from repro_torch.sharding import DistContext, params_axes
    from repro_torch.train import make_prefill_step, make_serve_step
    from repro_torch.tree import tree_map

    dist = DistContext(mesh, flags=frozenset(case.get("flags", ())))
    cfg = configs.smoke_config(case["arch"]).with_(**case.get("cfg", {}))
    dt = torch_dtype(cfg.dtype)
    params = dist.distribute(case["params"], dist.param_shardings(
        param_shapes(model_spec(cfg), dt), params_axes(cfg)))
    prompt = case["prompt"]
    b = prompt.shape[0]
    batch = {"tokens": prompt}
    if case.get("embeds") is not None:
        batch["embeds"] = case["embeds"]
    if cfg.encoder_only:
        logits = make_prefill_step(cfg, dist=dist)(params, batch)
        if rank == 0:
            results[name] = {"logits": [logits]}
        return

    def placed(caches):
        shapes = tree_map(lambda t: t.to("meta"), caches)
        return dist.distribute(caches, cache_sharding_tree(dist, cfg, shapes,
                                                           b))

    logits_all, tokens = [], []
    if case.get("paged"):
        caches = placed(init_paged_caches(cfg, b, case["max_len"], dt,
                                          page_size=case["page_size"],
                                          device="cpu"))
        serve = make_serve_step(cfg, dist=dist, paged=True)
        pages = case["pages"]
        feed = [prompt[:, t:t + 1] for t in range(prompt.shape[1])]
        for t in range(prompt.shape[1] + case["new"] - 1):
            tok = feed[t] if t < len(feed) else nxt[:, None]
            logits, nxt, caches = serve(
                params, tok, caches,
                torch.full((b,), t, dtype=torch.int32), pages)
            if t >= len(feed) - 1:
                logits_all.append(logits)
                tokens.append(nxt)
    else:
        caches = placed(init_caches(cfg, b, case["max_len"], dt, "cpu"))
        logits, caches = make_prefill_step(cfg, dist=dist)(params, batch,
                                                           caches)
        if cfg.padded_vocab != cfg.vocab_size:
            logits = logits.masked_fill(
                torch.arange(cfg.padded_vocab) >= cfg.vocab_size, -1e30)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        logits_all.append(logits)
        tokens.append(nxt)
        serve = make_serve_step(cfg, dist=dist)
        pos = prompt.shape[1] + (case["embeds"].shape[1]
                                 if case.get("embeds") is not None else 0)
        for t in range(case["new"] - 1):
            logits, nxt, caches = serve(params, nxt[:, None], caches,
                                        torch.tensor(pos + t,
                                                     dtype=torch.int32))
            logits_all.append(logits)
            tokens.append(nxt)
    if rank == 0:
        results[name] = {"logits": logits_all,
                         "tokens": torch.stack(tokens, 1)}


def _island_case(name, case, rank, world, axes, mesh, results):
    """``DistContext.decode_attention`` on each rank's slice of a cache cut
    over ``model`` on the sequence (and its batch rows): rank 0 records the
    gathered output."""
    from repro_torch.sharding import DistContext
    dist = DistContext(mesh, flags=frozenset({"flash_decode"}))
    tp = dist.tp_size
    s = case["k"].shape[1] // tp
    r = dist.axis_index(dist.tp_axis)
    rows = dist.batch_rows(case["q"].shape[0])
    cut = slice(r * s, (r + 1) * s)
    out = dist.decode_attention(
        case["q"][rows], case["k"][rows, cut], case["v"][rows, cut],
        case["kpos"][rows, cut], case["kpos"][rows, cut] >= 0,
        kv_chunk=case.get("kv_chunk", 8), q_offset=case["qpos"][rows])
    parts = [None] * world
    import torch.distributed as tdist
    tdist.all_gather_object(parts, (rows.start, out))
    if rank == 0:
        seen = {}
        for start, o in parts:
            seen.setdefault(start, o)
        results[name] = torch.cat([seen[k] for k in sorted(seen)])


def _fused_ce_case(name, case, rank, world, axes, mesh, results):
    """``DistContext.fused_ce`` at ``case["chunk"]`` on hidden states and a
    table placed as the train step places them: rank 0 records the loss,
    its metrics and the gathered gradients of the hidden states and the
    table."""
    from repro_torch import configs
    from repro_torch.models.layers import embedding_spec
    from repro_torch.models.params import logical_axes, param_shapes
    from repro_torch.sharding import DistContext
    dist = DistContext(mesh, flags=frozenset({"chunked_ce"}))
    cfg = configs.smoke_config(case["arch"])
    spec = embedding_spec(cfg)
    embed = dist.distribute(case["embed"], dist.param_shardings(
        param_shapes(spec, torch.float32), logical_axes(spec)))
    embed = {k: v.detach().requires_grad_(True) for k, v in embed.items()}
    b = dist.shard_batch({"hidden": case["hidden"],
                          "labels": case["labels"]})
    hidden = b["hidden"].detach().requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = dist.fused_ce(hidden, embed, cfg, b["labels"],
                                      chunk=case["chunk"])
        key = "embedding" if cfg.tie_embeddings else "unembed"
        gh, gw = torch.autograd.grad(
            loss, [hidden, embed[key]],
            grad_outputs=torch.full_like(loss, dist.grad_seed))
    gw = gw.redistribute(embed[key].device_mesh, embed[key].placements)
    # an activation's gradient is each rank's share where the activation
    # is replicated (DistContext's note): summed over those mesh dims
    from torch.distributed.tensor import DTensor, Partial, Replicate
    gh = DTensor.from_local(gh.to_local(), gh.device_mesh, [
        Partial() if isinstance(p, Replicate) else p for p in gh.placements],
        run_check=False)
    full = DistContext.gather({"hidden": gh, "table": gw})
    if rank == 0:
        results[name] = {"loss": float(loss.detach()),
                         "metrics": {k: float(v) for k, v in metrics.items()},
                         "grads": full}


def _fp8_gather_case(name, case, rank, world, axes, mesh, results):
    """``DistContext.gather_weight`` under ``fp8_gather`` on this rank's
    shard of ``w`` (cut on ``dim`` over the FSDP axes, as the MoE island's
    expert weights are) and its gradient for the cotangent ``g[rank]``:
    rank 0 records every rank's (``model`` index, FSDP index, gathered
    weight, gradient)."""
    import torch.distributed as tdist
    from repro_torch.sharding import DistContext
    from repro_torch.sharding.rules import axis_size
    dist = DistContext(mesh, flags=frozenset({"fp8_gather"}))
    fsdp = dist.fsdp_axes
    dim = case["dim"]
    i = dist.flat_index(fsdp)
    w = case["w"].chunk(axis_size(mesh, fsdp), dim)[i].clone()
    w.requires_grad_(True)
    with torch.enable_grad():
        out = dist.gather_weight(w, fsdp, dim)
        (gw,) = torch.autograd.grad(out, [w], grad_outputs=case["g"][rank])
    parts = [None] * world
    tdist.all_gather_object(parts, (dist.axis_index(dist.tp_axis), i,
                                    out.detach(), gw))
    if rank == 0:
        results[name] = parts


_RUNNERS = {"train": _train_case, "serve": _serve_case,
            "island": _island_case, "fused_ce": _fused_ce_case,
            "fp8_gather": _fp8_gather_case}


def _rank(rank: int, world: int, store_path: str, axes: dict,
          cases_path: str, out_path: str) -> None:
    import torch.distributed as tdist
    try:
        # one thread a rank where ranks share the host's cores (a world of
        # one keeps the single-device thread count, so that its bf16 steps
        # can equal the parent's to the bit)
        if world > 1:
            torch.set_num_threads(1)
        tdist.init_process_group(
            "gloo", store=tdist.FileStore(store_path, world), rank=rank,
            world_size=world)
        from repro_torch.launch.mesh import make_smoke_mesh
        mesh = make_smoke_mesh(axes.get("data", 1), axes["model"],
                               axes.get("pod", 0), device_type="cpu")
        cases = torch.load(cases_path, weights_only=False)
        results = {}
        for name, case in cases.items():
            _RUNNERS[case.get("kind", "train")](name, case, rank, world,
                                                axes, mesh, results)
        if rank == 0:
            torch.save(results, out_path)
        tdist.barrier()
        tdist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def spawn_world(axes: dict, cases: dict, tmp_dir, timeout: float = 600.0
                ) -> dict:
    """Run ``cases`` ({name: {"arch", "state", "batch" or "batches",
    "knobs"[, "cfg"]}}) on a
    world with the mesh ``axes`` ({"pod"?, "data", "model"}); rank 0's
    results per case. Raises if a rank fails or the world outlives
    ``timeout`` seconds."""
    world = 1
    for n in axes.values():
        world *= n
    cases_path = os.path.join(str(tmp_dir), "cases.pt")
    out_path = os.path.join(str(tmp_dir), "results.pt")
    torch.save(cases, cases_path)
    ctx = mp.start_processes(
        _rank, args=(world, os.path.join(str(tmp_dir), "store"), axes,
                     cases_path, out_path),
        nprocs=world, join=False, start_method="spawn")
    import time
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {world}-rank world ran past "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return torch.load(out_path, weights_only=False)
