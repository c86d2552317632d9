"""One run of one cell, driven by data: the cell's entry in
``BENCHMARK.json`` names a configuration file (``configs/<config>.json``), a
traffic mix (``traffic/<mix>.json``) and, through its metrics, one reader
each (``metrics/<metric>.py``). The configuration names its family: the
plain reference (``reference/<family>.py``) and the program's configuration
of it (``adapters/<family>.py``). The mix names its kind: the driver that
feeds the program (``drivers/<kind>.py``). Limits of the correctness check
are ``limits/<workload>.json``. A cell is added by adding such files and
entries; none of this module needs an edit for it.

A run: set-up (weights and inputs on the device from the seed, the
program's step or call built, every shape the window uses warmed up, and
for a training cell its checked steps), then the window of ``seconds``,
then with ``trace`` a stretch under ``torch.profiler``, then the check
against the reference once the program's state is freed.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Callable

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` and the files its names lead to."""

    def __init__(self, path: Path = ROOT / "BENCHMARK.json"):
        self.data = load_json(path)

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config_file(self, config: str) -> Path:
        for c in self.data["configs"]:
            if c["name"] == config:
                return ROOT / c["file"]
        raise KeyError(f"no config {config!r} in BENCHMARK.json")

    def spec(self, config: str) -> dict:
        return load_json(self.config_file(config))

    @staticmethod
    def traffic(mix: str) -> dict:
        return load_json(HERE / "traffic" / f"{mix}.json")

    @staticmethod
    def limits(workload: str) -> dict:
        return load_json(HERE / "limits" / f"{workload}.json")

    def metrics(self, workload: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer
        ones: those that list it, or list no cells."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if workload in m.get("workloads", [workload])]


def reader(name: str) -> Callable:
    """``read(run)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """One run's inputs, and what the driver measured."""
    bench: Bench
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: str
    spec: dict
    traffic: dict
    limits: dict
    ref: ModuleType
    adapter: ModuleType
    t_start: float
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0                      # steps or calls in the window
    positions: int = 0                  # positions they processed
    traced: Any = None                  # trace.Trace of the traced stretch
    memory_peak: int = 0
    gaps: dict = field(default_factory=dict)
    phases: dict = field(default_factory=dict)   # set-up's parts, seconds

    def phase(self, name: str) -> None:
        """Record when a part of set-up ended, in seconds from the start,
        once the device has finished it."""
        synchronize(self.device)
        self.phases[name] = time.perf_counter() - self.t_start

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def unit_positions(self) -> int:
        return self.traffic["batch"] * self.traffic["seq"]

    @property
    def dtype(self):
        """The configuration's working dtype (weights and frames)."""
        import torch
        return getattr(torch, self.spec["dtype"])

    def weights(self) -> dict:
        """The weights, drawn on the device from the seed; the same on
        every call."""
        from portbench.reference.common import make_weights
        return make_weights(self.ref.weight_leaves(self.spec), self.seed,
                            self.device, self.dtype)


def make_run(bench: Bench, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             spec: dict | None = None, traffic: dict | None = None) -> Run:
    w = bench.workload(workload)
    spec = spec if spec is not None else bench.spec(w["config"])
    traffic = traffic if traffic is not None else bench.traffic(w["traffic"])
    return Run(bench=bench, workload=workload, seed=seed, seconds=seconds,
               trace=trace, device=device, spec=spec, traffic=traffic,
               limits=bench.limits(workload),
               ref=importlib.import_module(
                   f"portbench.reference.{spec['family']}"),
               adapter=importlib.import_module(
                   f"portbench.adapters.{spec['family']}"),
               t_start=t_start)


# -- pacing and windows -----------------------------------------------------

def synchronize(device: str) -> None:
    import torch
    if device.startswith("cuda"):
        torch.cuda.synchronize()


class Pace:
    """Keeps the host at most one step or call ahead of the device: after
    each launch it waits for the one before, so the device always has the
    next unit queued and the host never races ahead."""

    def __init__(self, device: str):
        self.cuda = device.startswith("cuda")
        self.prev = None

    def launched(self) -> None:
        if not self.cuda:
            return
        import torch
        ev = torch.cuda.Event()
        ev.record()
        if self.prev is not None:
            self.prev.synchronize()
        self.prev = ev


def window(run: Run, launch: Callable[[], None]) -> None:
    """Launch units until ``run.seconds`` have passed on the host clock,
    then wait for the last: the window ends with the last completed unit."""
    synchronize(run.device)
    pace = Pace(run.device)
    n = 0
    t0 = time.perf_counter()
    while True:
        launch()
        n += 1
        pace.launched()
        if time.perf_counter() - t0 >= run.seconds:
            break
    synchronize(run.device)
    run.window_s = time.perf_counter() - t0
    run.units = n
    run.positions = n * run.unit_positions()


def traced(run: Run, units: int, launch: Callable[[], None]) -> None:
    """Two stretches of ``units`` launches under ``torch.profiler``,
    reduced by :func:`portbench.trace.summarize`. The first records the
    device alone, which costs the host next to nothing: busy time, the
    stretch's wall time and the device operations come from it. The
    second records the host's ops too, whose cost makes the host the
    pace: the device time under each entry point, and the labels of the
    idle gaps (which that cost widens), come from it."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.trace import summarize
    cuda = run.device.startswith("cuda")
    passes = []
    for acts in ([ProfilerActivity.CUDA] if cuda else [],
                 [ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if cuda else [])):
        if not acts:
            continue
        synchronize(run.device)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            pace = Pace(run.device)
            for _ in range(units):
                launch()
                pace.launched()
            synchronize(run.device)
            wall = time.perf_counter() - t0
        passes.append(summarize(prof, wall))
    device, host = passes[0], passes[-1]
    host.busy_s, host.window_s = device.busy_s, device.window_s
    host.device_ops = device.device_ops
    run.traced = host


class Reservoir:
    """A uniform sample of ``k`` of the units offered, drawn from the
    seed, holding only what it keeps."""

    def __init__(self, k: int, seed: int):
        from portbench.reference.common import sub_seed
        self.k = k
        self.rng = random.Random(sub_seed(seed, "sample"))
        self.kept: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.kept[j] = item
        self.seen += 1


# -- the layout the benchmark hands the program ------------------------------

def check_layout(cfg, weights: dict) -> None:
    """Raise unless ``weights`` has the leaves, shapes and dtypes that the
    program's parameter tree for ``cfg`` has."""
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.params import param_shapes
    from repro_torch.models.transformer import model_spec

    from portbench.reference.common import leaf_items
    want = {p: (tuple(t.shape), t.dtype) for p, t in leaf_items(
        param_shapes(model_spec(cfg), torch_dtype(cfg.dtype)))}
    got = {p: (tuple(t.shape), t.dtype) for p, t in leaf_items(weights)}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()), key=str)
        raise ValueError(f"the program's parameter layout differs from the "
                         f"benchmark's weights: {diff[:8]}")


# -- one run -----------------------------------------------------------------

def forbidden_modules() -> list[str]:
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def run_cell(run: Run) -> dict:
    """Drive the cell, check it, read its metrics: the result's fields
    (``checks`` last)."""
    driver = importlib.import_module(f"portbench.drivers.{run.kind}")
    driver.drive(run)
    from portbench.check import verdict
    ok, checks = verdict(run.gaps, run.limits)
    metrics = {}
    for m in run.bench.metrics(run.workload, run.trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": ok, "attempted": run.units,
           "failed": sum(v > lim or v != v for v, lim in checks.values()),
           "metrics": metrics, "device": device_info(run)}
    if run.trace and run.traced is not None:
        out["breakdown"] = {"device_ops": run.traced.device_ops,
                            "idle_gaps": run.traced.idle_gaps}
    out["checks"] = checks
    return out


def device_info(run: Run) -> dict:
    import torch
    if run.device.startswith("cuda"):
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": run.memory_peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if run.trace and run.traced is not None:
        info["busy_s"] = run.traced.busy_s
        info["window_s"] = run.traced.window_s
    return info
