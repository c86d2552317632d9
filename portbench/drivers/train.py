"""A training cell: the program's ``make_train_step`` on one train state.

Set-up builds the train state from the benchmark's weights (bf16 params,
the program's AdamW state with its float32 master copy), draws the mix's
batches, and drives the very step function and state of the window
through its first ``check_steps`` steps, on batches that all differ. It
reads there what the check compares: each step's loss, the first step's
gradient as the optimizer holds it (its first moment over 1 - beta1, the
clipped gradient) and, after the last checked step, the master copy's
change from the initial weights. The window then runs on from that state.
Once the window (and a traced stretch) is over and the program's state is
freed, the reference follows the checked steps from the same weights and
batches.
"""
from __future__ import annotations

import time

import torch

from portbench import harness
from portbench.check import leaf_norms, train_gaps
from portbench.generate import make_batches
from portbench.reference.common import (FULL, AdamW, Precision, leaf_items,
                                        no_tf32)


def batches(run: harness.Run) -> list[dict]:
    return make_batches(run.traffic, run.ref.inputs(run.spec), run.seed,
                        run.device, run.dtype)


def program_setup(run: harness.Run, data: list[dict]):
    """(step function, train state after the checked steps, the program's
    readings of those steps)."""
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.train.step import TrainState, make_train_step

    recipe = run.spec["train"]
    o = recipe["optimizer"]
    ocfg = OptimizerConfig(
        lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
        weight_decay=o["weight_decay"], grad_clip=o["grad_clip"],
        moment_dtype="float32", master_dtype=recipe["master_dtype"],
        warmup_steps=0, total_steps=1, schedule="constant")
    cfg = run.adapter.port_config(run.spec, run.spec["dtype"])
    params = run.weights()
    harness.check_layout(cfg, params)
    run.phase("weights")
    state = TrainState(params=params, opt=adamw_init(params, ocfg),
                       step=torch.zeros((), dtype=torch.int32,
                                        device=run.device))
    del params
    run.phase("optimizer")
    step = make_train_step(cfg, ocfg)
    losses, grad = [], None
    for i in range(run.traffic["check_steps"]):
        state, metrics = step(state, data[i])
        losses.append(metrics["loss"])
        if i == 0:
            grad = leaf_norms((p, m / (1.0 - o["b1"]))
                              for p, m in leaf_items(state.opt["m"]))
    run.phase("checked_steps")
    init = dict(leaf_items(run.weights()))
    change = leaf_norms((p, w - init.pop(p).float())
                        for p, w in leaf_items(state.opt["master"]))
    readings = {"losses": [float(x) for x in losses], "grad": grad,
                "change": change}
    return step, state, readings


def reference(run: harness.Run, data: list[dict],
              prec: Precision = FULL, rows: int | None = None) -> dict:
    """The reference's readings of the checked steps: float32 products (or
    ``prec``'s), params the master copy rounded to the configuration's
    dtype, the recipe's AdamW. ``rows``: only the first rows of each batch
    (a fault planted in the reference)."""
    no_tf32()
    recipe = run.spec["train"]
    adam = AdamW.from_recipe(recipe["optimizer"])
    dt = run.dtype
    paths, master = [], []
    for p, w in leaf_items(run.weights()):
        paths.append(p)
        master.append(w.float())
    init = [w.clone() for w in master]
    m = [torch.zeros_like(w) for w in master]
    v = [torch.zeros_like(w) for w in master]
    losses, grad = [], None
    for i in range(run.traffic["check_steps"]):
        params = [w.to(dt).float().requires_grad_(True) for w in master]
        tree = {}
        for p, t in zip(paths, params):
            node = tree
            for k in p[:-1]:
                node = node.setdefault(k, {})
            node[p[-1]] = t
        batch = {k: (t.float() if t.is_floating_point() else t)[:rows]
                 for k, t in data[i].items()}
        with torch.enable_grad():
            loss = run.ref.loss(tree, run.spec, batch, recipe["z_loss"], prec)
            grads = torch.autograd.grad(loss, params, allow_unused=True,
                                        materialize_grads=True)
        clipped = adam.step(master, [g.detach() for g in grads], m, v, i + 1)
        losses.append(float(loss.detach()))
        if i == 0:
            grad = leaf_norms(zip(paths, clipped))
        del params, grads, clipped, tree, loss
    change = leaf_norms((p, w - w0) for p, w, w0 in zip(paths, master, init))
    return {"losses": losses, "grad": grad, "change": change}


def drive(run: harness.Run) -> None:
    data = batches(run)
    run.phase("batches")
    step, state, prog = program_setup(run, data)
    harness.synchronize(run.device)
    run.setup_s = time.perf_counter() - run.t_start
    n_check, pool = run.traffic["check_steps"], len(data)
    box = {"state": state, "i": n_check}
    del state

    def launch():
        box["state"], _ = step(box["state"], data[box["i"] % pool])
        box["i"] += 1

    harness.window(run, launch)
    if run.trace:
        harness.traced(run, run.traffic["trace_steps"], launch)
    if run.device.startswith("cuda"):
        run.memory_peak = torch.cuda.max_memory_allocated()
    box.clear()
    del step
    if run.device.startswith("cuda"):
        torch.cuda.empty_cache()
    run.gaps = train_gaps(prog, reference(run, data[:n_check]))
