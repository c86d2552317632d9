"""The port's step spans (``repro_torch.obs.trace.span``) under
``torch.profiler``.

On the CPU, one train step and one encoder call of two smoke
configurations (mamba2: SSD blocks without an MLP; hubert: attention
blocks with an MLP): each ``repro.*`` range appears as often as the step
runs its part, the phases nest in ``repro.train_step`` and every op of the
step falls in exactly one of them, the backward's autograd nodes run inside
``repro.backward``, no range is a user annotation, and a step without a
profiler adds nothing to the autograd graph and computes what a profiled
step computes, bit for bit.

Marked ``cuda`` (skipped without a card; this file imports no jax): each
hand kernel's label holds the device time of its autograd function, and
``repro.backward`` holds the backward's kernels on the autograd engine's
device thread, where a range opened by the caller would hold none.
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_spans.py``.
"""
import threading
from collections import Counter, defaultdict

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.data import batch_at
from repro_torch.optim import OptimizerConfig
from repro_torch.train import init_train_state, make_prefill_step
from repro_torch.train import step as step_mod
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves

PHASES = ("repro.forward", "repro.backward", "repro.optimizer")
ENGINE_OP = "autograd::engine::evaluate_function:"


def _setup(arch, device="cpu", microbatch=None):
    cfg = configs.smoke_config(arch)
    ocfg = OptimizerConfig()
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_train_state(cfg, ocfg, gen, device)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in batch_at(cfg, 0, 0, batch=4, seq=32).items()}
    return cfg, state, batch, make_train_step(cfg, ocfg,
                                              microbatch=microbatch)


def _profiled(fn, cuda=False):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        out = fn()
        if cuda:
            torch.cuda.synchronize()
    return out, list(prof.events())


def _ancestors(e):
    names, p = [], e.cpu_parent
    while p is not None:
        names.append(p.name)
        p = p.cpu_parent
    return names


def _counts(events):
    return Counter(e.name for e in events if e.name.startswith("repro."))


def _n_mlp(cfg):
    return cfg.n_layers if cfg.d_ff > 0 else 0


@pytest.mark.parametrize("arch", ["mamba2_130m", "hubert_xlarge"])
def test_train_step_spans(arch):
    cfg, state, batch, step = _setup(arch)
    _, events = _profiled(lambda: step(state, batch))
    assert _counts(events) == Counter({
        "repro.train_step": 1, "repro.forward": 1, "repro.backward": 1,
        "repro.optimizer": 1, "repro.mixer": cfg.n_layers,
        **({"repro.ffn": _n_mlp(cfg)} if _n_mlp(cfg) else {})})
    for e in events:
        if e.name.startswith("repro."):
            assert not e.is_user_annotation, e.name
        if e.name in PHASES:
            assert _ancestors(e) == ["repro.train_step"], e.name
    nodes = [e for e in events if e.name.startswith(ENGINE_OP)]
    assert nodes
    assert all("repro.backward" in _ancestors(e) for e in nodes)
    # every op of the step, forward, backward or optimizer's, is in one phase
    ops = [e for e in events if e.name.startswith("aten::")]
    assert ops
    for e in ops:
        up = _ancestors(e)
        assert "repro.train_step" in up, e.name
        assert len(set(up) & set(PHASES)) == 1, (e.name, up)


def test_microbatched_step_opens_phases_per_microbatch():
    """Two microbatches: the phases open once a microbatch (the placing of
    the parts in ``repro.forward``, the accumulation in ``repro.backward``),
    and still every op falls in exactly one phase."""
    cfg, state, batch, step = _setup("hubert_xlarge", microbatch=2)
    _, events = _profiled(lambda: step(state, batch))
    got = _counts(events)
    assert got["repro.train_step"] == 1 and got["repro.optimizer"] == 1
    assert got["repro.forward"] == 3 and got["repro.backward"] == 5
    assert got["repro.mixer"] == got["repro.ffn"] == 2 * cfg.n_layers
    for e in events:
        if e.name.startswith("aten::"):
            assert len(set(_ancestors(e)) & set(PHASES)) == 1, e.name


def test_encode_spans():
    cfg = configs.smoke_config("hubert_xlarge")
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import model_spec
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0),
                         torch_dtype(cfg.dtype), torch.device("cpu"))
    embeds = torch.from_numpy(batch_at(cfg, 0, 0, batch=2,
                                       seq=32)["embeds"])
    call = make_prefill_step(cfg)
    _, events = _profiled(lambda: call(params, {"embeds": embeds}))
    assert _counts(events) == Counter({"repro.encode": 1,
                                       "repro.mixer": cfg.n_layers,
                                       "repro.ffn": cfg.n_layers})
    for e in events:
        if e.name in ("repro.mixer", "repro.ffn"):
            assert _ancestors(e) == ["repro.encode"]
            assert not e.is_user_annotation
        if e.name.startswith("aten::"):
            assert "repro.encode" in _ancestors(e), e.name


def test_no_profiler_adds_no_node(monkeypatch):
    calls = []
    real = step_mod._BackwardSpan.apply

    def counted(loss):
        calls.append(1)
        return real(loss)

    monkeypatch.setattr(step_mod._BackwardSpan, "apply", counted)
    _, state, batch, step = _setup("mamba2_130m")
    step(state, batch)
    assert calls == []
    loss = (torch.ones(3, requires_grad=True) * 2).sum()
    assert step_mod._backward_root(loss) is loss
    _profiled(lambda: step(state, batch))
    assert calls == [1]
    root, _ = _profiled(lambda: step_mod._backward_root(loss))
    assert root is not loss and torch.equal(root, loss)
    assert type(root.grad_fn).__name__ == "_BackwardSpanBackward"


@pytest.mark.parametrize("arch", ["mamba2_130m", "hubert_xlarge"])
def test_profiler_changes_no_number(arch):
    """Loss, metrics and the whole new state (params, float32 master, the
    moments: the first carries the gradient) are bit-equal with and
    without the profiler."""
    _, state, batch, step = _setup(arch)
    plain, plain_m = step(state, batch)
    (traced, traced_m), _ = _profiled(lambda: step(state, batch))
    assert plain_m.keys() == traced_m.keys()
    for k in plain_m:
        assert torch.equal(plain_m[k], traced_m[k]), k
    a, b = leaves(plain), leaves(traced)
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_backward_range_opened_by_another_thread_closes_at_the_end():
    """Where the backward runs on another thread than the loss was made on
    (on CUDA, the engine's device thread), :class:`_BackwardSpan` opens
    ``repro.backward`` on the backward's thread and closes it there when
    the engine has finished: the range holds every autograd node after the
    identity's own, in which it opened. The loss is made on a thread of its
    own here, so the CPU's backward, which runs on the caller's thread,
    takes that path."""
    x = torch.arange(6.0, requires_grad=True)
    loss = (x.sin() * x).sum()
    box = []
    t = threading.Thread(target=lambda: box.append(
        step_mod._BackwardSpan.apply(loss)))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and box
    (g,), events = _profiled(lambda: torch.autograd.grad(box[0], [x]))
    torch.testing.assert_close(g, x.cos() * x + x.sin())
    spans = [e for e in events if e.name == "repro.backward"]
    assert len(spans) == 1
    nodes = [e for e in events if e.name.startswith(ENGINE_OP)
             and not e.name.endswith("_BackwardSpanBackward")]
    assert len(nodes) >= 3
    assert all("repro.backward" in _ancestors(e) for e in nodes)
    assert spans[0].time_range.end >= max(e.time_range.end for e in nodes)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _device_under(events):
    """Device seconds credited to each host op name: every kernel to the
    host op that launched it and to each op around it on its thread."""
    out = defaultdict(float)
    for e in events:
        if e.device_type.name == "CUDA":
            continue
        own = sum(k.duration for k in e.kernels) * 1e-6
        if own > 0:
            for n in {e.name, *_ancestors(e)}:
                out[n] += own
    return out


def _no_device_span(events):
    return not [e.name for e in events if e.device_type.name == "CUDA"
                and e.name.startswith("repro.")]


@pytest.mark.cuda
def test_kernel_labels_hold_their_functions_time_on_card(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd import ssd_scan
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=g, device=cuda_device)
                * scale).to(dtype).requires_grad_(True)

    b, s, h, p, n = 2, 2048, 24, 64, 128
    x, bm, cm = rnd(b, s, h, p), rnd(b, s, n), rnd(b, s, n)
    dt = (torch.rand(b, s, h, generator=g, device=cuda_device) * 0.1
          ).requires_grad_(True)
    a = (-torch.rand(h, generator=g, device=cuda_device) - 0.5
         ).requires_grad_(True)
    q, k, v = (rnd(2, 2048, 16, 80, scale=0.5) for _ in range(3))

    def run():
        y, _ = ssd_scan(x, dt, a, bm, cm)
        y.float().square().sum().backward()
        o = flash_attention(q, k, v, causal=False)
        o.float().square().sum().backward()

    run()
    torch.cuda.synchronize()
    _, events = _profiled(run, cuda=True)
    under = _device_under(events)
    for label, fn in (("repro.kernel.ssd_scan", "SSDScanFn"),
                      ("repro.kernel.ssd_scan_bwd", "SSDScanFnBackward"),
                      ("repro.kernel.flash_attention", "FlashAttentionFn"),
                      ("repro.kernel.flash_attention_bwd",
                       "FlashAttentionFnBackward")):
        assert under[fn] > 0, fn
        assert 0.99 * under[fn] <= under[label] <= under[fn] * (1 + 1e-9), \
            (label, under[label], fn, under[fn])
    assert _no_device_span(events)


@pytest.mark.cuda
def test_backward_range_holds_the_engine_threads_kernels_on_card(
        cuda_device):
    _, state, batch, step = _setup("mamba2_130m", device="cuda")
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    _, events = _profiled(lambda: step(state, batch), cuda=True)
    spans = [e for e in events if e.name == "repro.backward"]
    main = {e.thread for e in events if e.name == "repro.train_step"}
    engine = [e for e in spans if e.thread not in main]
    assert len(main) == 1 and engine, [(e.name, e.thread) for e in spans]
    under = _device_under(events)
    # the scan's backward kernels run on the engine's thread, inside it
    assert under["SSDScanFnBackward"] > 0
    bwd_nodes = [e for e in events if e.name == "SSDScanFnBackward"]
    assert all("repro.backward" in _ancestors(e) for e in bwd_nodes)
    # every kernel of the step is in exactly one phase
    total = sum(k.duration for e in events if e.device_type.name != "CUDA"
                for k in e.kernels) * 1e-6
    phases = sum(under[p] for p in PHASES)
    assert total > 0 and abs(phases - total) <= 1e-9 * total + 1e-12
    for e in events:
        if e.device_type.name != "CUDA" and e.kernels:
            assert len({e.name, *_ancestors(e)} & set(PHASES)) == 1, e.name
    assert _no_device_span(events)
