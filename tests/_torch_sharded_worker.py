"""The ranks of the port's sharded-step tests (``tests/test_torch_sharded_step.py``):
one process per rank on the CPU, gloo over a ``FileStore``, no jax.

:func:`spawn_world` starts a world, each rank runs :func:`_rank` over the
cases the parent wrote with ``torch.save`` (a train state, a batch, the
optimizer config and the step's knobs; a case with ``batches`` takes one
step on each, and ``cfg`` changes its smoke config) and rank 0 writes back,
per case, the last step's metrics, every step's loss, the gathered params
and optimizer state after the last step, and for every rank the leaves whose local shard shape is not
the one the sharding rules give, and the elements it holds.
"""
import os
import sys
import traceback

import torch
import torch.multiprocessing as mp

def _rank(rank: int, world: int, store_path: str, axes: dict,
          cases_path: str, out_path: str) -> None:
    import torch.distributed as tdist
    try:
        tdist.init_process_group(
            "gloo", store=tdist.FileStore(store_path, world), rank=rank,
            world_size=world)
        from repro_torch import configs
        from repro_torch.launch.mesh import make_smoke_mesh
        from repro_torch.optim import OptimizerConfig
        from repro_torch.sharding import DistContext, state_axes
        from repro_torch.sharding.rules import resolve_spec
        from repro_torch.train import (make_train_step, shard_train_state,
                                       train_state_shapes)
        from repro_torch.tree import flatten_up_to, leaves, paths

        mesh = make_smoke_mesh(axes.get("data", 1), axes["model"],
                               axes.get("pod", 0), device_type="cpu")
        dist = DistContext(mesh)
        cases = torch.load(cases_path, weights_only=False)
        results = {}
        for name, case in cases.items():
            cfg = configs.smoke_config(case["arch"]).with_(
                **case.get("cfg", {}))
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
