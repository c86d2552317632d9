"""The four flag-gated islands of the port's ``DistContext`` on CPU worlds
of gloo ranks: ``chunked_ce``, ``fp8_gather``, ``weight_stationary`` and
the ``flash_decode`` island's merge where shards hold no valid key.

Two worlds of 8 ranks (``tests/_torch_sharded_worker.py``), each started
once: world A on ``tests/island_check_opt.py``'s (data=2, model=4) mesh,
world B on (pod=2, data=2, model=2), where the weight-stationary island's
d-slice and batch-slice indices compose two FSDP axes. The reference's
sharded program is no oracle on this jax (``ROADMAP.md`` Queue 3); each
island is held to the port's single-device program:

* ``chunked_ce`` (gemma3-1b, tied table; stablelm, its own unembedding):
  one train step's loss within 1e-5 relative of the single-device step's,
  and its params within 1e-5 (``tests/test_torch_train.py``'s limit); the
  island alone at a chunk of 24 tokens (ragged: the last chunk is short)
  against ``lm_loss`` of the whole logits, loss and the gradients of the
  hidden states and the table within 1e-5;
* ``fp8_gather`` (moonshot): the loss within 1e-5 of a plain emulation
  (the expert weights cast to ``float8_e4m3fn`` and back, on one device,
  each batch shard's forward on its own as the sharded MoE's capacity
  is), and within 2e-2 relative of the unquantised loss
  (``island_check_opt.py``'s limit), the emulation itself further than
  1e-5 from the unquantised loss, so that the first limit tells the two
  apart; the gather alone, on both worlds: every rank's gathered weight
  is the e4m3 cast of the whole weight, and each shard's gradient the
  sum, over the ranks of its ``model`` index, of their cotangents rounded
  to e4m3, cut to the rank's FSDP shard (within 1e-6: float32 sums in
  another order);
* ``weight_stationary`` with ``flash_decode`` (deepseek): a prefill and 16
  greedy tokens on both worlds, the tokens equal to the default-flag
  decode's in the same world and every step's logits within 1e-5 of them;
* the ``flash_decode`` island on slices of a cache where every rank but
  the first holds no valid key (and on world B, slots whose last shards
  are empty): the merged output finite and within 1e-5 of the attention
  over the whole cache.

Without a world: ``chunked_attention(return_stats=True)`` against the
reference's, and ``DistContext`` taking every flag.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_sharded_worker import spawn_world
from repro.models.attention import chunked_attention as jax_chunked
from repro_torch import configs
from repro_torch.kernels.flash_decode import flash_decode_ref
from repro_torch.launch.mesh import smoke_axes
from repro_torch.models import forward, init_params, model_spec
from repro_torch.models.attention import chunked_attention
from repro_torch.models.layers import unembed
from repro_torch.optim import OptimizerConfig
from repro_torch.sharding import DistContext
from repro_torch.sharding.context import FLAGS
from repro_torch.train import init_train_state, lm_loss, make_train_step
from repro_torch.tree import leaves

ATOL = 1e-5
FP8_REL = 2e-2       # tests/island_check_opt.py::check_fp8_gather_moe
B, S = 4, 32         # island_check_opt.py's train batch
WORLD_TIMEOUT = 600.0
# island_check_opt.py's optimizer (no decay, constant rate) at Adam eps
# 1e-5, as tests/test_torch_train.py's STEP_OPT: at eps 1e-8 an element
# whose gradient is near 0 turns a 1e-7 gradient difference into a step
# of the learning rate's size
OPT = dict(lr=1e-2, eps=1e-5, warmup_steps=0, schedule="constant",
           weight_decay=0.0)
CE_ARCHS = ("gemma3_1b", "stablelm_1_6b")
FP8_ARCH, WS_ARCH = "moonshot_v1_16b_a3b", "deepseek_v3_671b"
FP8_W = (2, 8, 6)    # (experts, d, f): d cut over the FSDP axes
PROMPT, NEW = 24, 16
CE_CHUNK = 24


def _batch(cfg, seed):
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))
                                .astype(np.int32))
            for k in ("tokens", "labels")}


def _state(cfg, seed):
    return init_train_state(cfg, OptimizerConfig(**OPT),
                            torch.Generator().manual_seed(seed), "cpu")


def _quantised(params):
    """The routed experts' weights cast to float8_e4m3fn and back."""
    def walk(t):
        if isinstance(t, dict):
            return {k: (v.to(torch.float8_e4m3fn).to(v.dtype)
                        if k in ("w_gate", "w_up", "w_down")
                        and not isinstance(v, dict) and v.dim() == 4
                        else walk(v)) for k, v in t.items()}
        return t
    return walk(params)


def _per_shard_loss(cfg, params, batch, n_shards):
    """The loss the sharded step defines for a MoE: each batch shard's
    forward on its own (capacity and aux per shard), the cross-entropy over
    the batch, the aux the mean of the shards'."""
    outs = [forward(params, cfg, {k: v.chunk(n_shards)[i]
                                  for k, v in batch.items()})
            for i in range(n_shards)]
    loss, m = lm_loss(torch.cat([o[0] for o in outs]), batch["labels"])
    aux = sum(o[2] for o in outs) / n_shards
    return float(loss + cfg.moe.router_aux_weight * aux), float(m["ce"])


def _island_inputs(seed, empty_from):
    """A decode over 64 cache rows (K=1, G=4, D=16), slots at positions
    ``empty_from - 1`` and below, so the rows from ``empty_from`` on hold
    no valid key."""
    rng = np.random.RandomState(seed)
    s = 64
    q = torch.from_numpy(rng.randn(B, 1, 4, 16).astype(np.float32))
    k = torch.from_numpy(rng.randn(B, s, 1, 16).astype(np.float32))
    v = torch.from_numpy(rng.randn(B, s, 1, 16).astype(np.float32))
    qpos = torch.tensor([empty_from - 1 - i for i in range(B)],
                        dtype=torch.int32)
    kpos = torch.arange(s, dtype=torch.int32).expand(B, s)
    kpos = torch.where(kpos <= qpos[:, None], kpos, -1)
    return {"kind": "island", "q": q, "k": k, "v": v, "qpos": qpos,
            "kpos": kpos.contiguous()}


def _serve_case(arch, flags, seed=5):
    cfg = configs.smoke_config(arch)
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(seed),
                         torch.float32, "cpu")
    rng = np.random.RandomState(seed)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, PROMPT))
                              .astype(np.int32))
    return {"kind": "serve", "arch": arch, "params": params,
            "prompt": prompt, "new": NEW, "max_len": PROMPT + NEW,
            "flags": flags}


@pytest.fixture(scope="module")
def cases():
    out, refs = {}, {}
    for arch in CE_ARCHS:
        cfg = configs.smoke_config(arch)
        st, batch = _state(cfg, 0), _batch(cfg, 0)
        new, m = make_train_step(cfg, OptimizerConfig(**OPT))(st, batch)
        out[("chunked_ce", arch)] = {"arch": arch, "state": st,
                                     "batch": batch, "knobs": {},
                                     "opt": OPT, "flags": ("chunked_ce",)}
        refs[("chunked_ce", arch)] = {"loss": float(m["loss"]),
                                      "params": new.params}
        # the island alone, at a ragged chunk
        rng = np.random.RandomState(3)
        hidden = torch.from_numpy(rng.randn(B, S, cfg.d_model)
                                  .astype(np.float32))
        embed = {k: v.detach().clone()
                 for k, v in st.params["embed"].items()}
        out[("fused_ce", arch)] = {"kind": "fused_ce", "arch": arch,
                                   "hidden": hidden, "labels": batch["labels"],
                                   "embed": embed, "chunk": CE_CHUNK}
        h = hidden.clone().requires_grad_(True)
        key = "embedding" if cfg.tie_embeddings else "unembed"
        w = embed[key].clone().requires_grad_(True)
        loss, _ = lm_loss(unembed({key: w}, cfg, h), batch["labels"])
        gh, gw = torch.autograd.grad(loss, [h, w])
        refs[("fused_ce", arch)] = {"loss": float(loss.detach()),
                                    "hidden": gh,
                                    "table": gw}
    cfg = configs.smoke_config(FP8_ARCH)
    st, batch = _state(cfg, 1), _batch(cfg, 1)
    out[("fp8_gather", FP8_ARCH)] = {"arch": FP8_ARCH, "state": st,
                                     "batch": batch, "knobs": {}, "opt": OPT,
                                     "flags": ("fp8_gather",)}
    with torch.no_grad():
        n = 2      # world A's batch shards (data=2)
        refs[("fp8_gather", FP8_ARCH)] = {
            "emulated": _per_shard_loss(cfg, _quantised(st.params), batch, n),
            "plain": _per_shard_loss(cfg, st.params, batch, n)}
    rng = np.random.RandomState(9)
    n_ranks = 8
    # cotangents over e4m3's range: normal, subnormal and flushed to zero
    g = rng.randn(n_ranks, *FP8_W) * 10.0 ** rng.uniform(-4, 1, (n_ranks,
                                                                 *FP8_W))
    out[("fp8_gather_op", "experts")] = {
        "kind": "fp8_gather", "dim": 1,
        "w": torch.from_numpy(rng.randn(*FP8_W).astype(np.float32)),
        "g": torch.from_numpy(g.astype(np.float32))}
    for f, flags in (("default", ()),
                     ("weight_stationary", ("flash_decode",
                                            "weight_stationary"))):
        out[(f, WS_ARCH)] = _serve_case(WS_ARCH, flags)
    out[("island", "one_rank_holds_keys")] = _island_inputs(4, 16)
    out[("island", "last_shards_empty")] = _island_inputs(6, 40)
    return out, refs


def _island_ref(case):
    return flash_decode_ref(case["q"], case["k"], case["v"], case["qpos"],
                            case["kpos"], bounded=False)


@pytest.fixture(scope="module")
def world_a(cases, tmp_path_factory):
    return spawn_world(smoke_axes(2, 4), cases[0],
                       tmp_path_factory.mktemp("world_a"),
                       timeout=WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def world_b(cases, tmp_path_factory):
    keep = {k: v for k, v in cases[0].items()
            if k[1] == WS_ARCH or k[0] in ("island", "fp8_gather_op")}
    return spawn_world(smoke_axes(2, 2, pods=2), keep,
                       tmp_path_factory.mktemp("world_b"),
                       timeout=WORLD_TIMEOUT)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-9)


@pytest.mark.parametrize("arch", CE_ARCHS)
def test_chunked_ce_step_matches_single_device(world_a, cases, arch):
    got, ref = world_a[("chunked_ce", arch)], cases[1][("chunked_ce", arch)]
    assert _rel(got["metrics"]["loss"], ref["loss"]) <= ATOL
    for a, b in zip(leaves(got["params"]), leaves(ref["params"])):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), atol=ATOL)


@pytest.mark.parametrize("arch", CE_ARCHS)
def test_fused_ce_chunks_and_gradients(world_a, cases, arch):
    got, ref = world_a[("fused_ce", arch)], cases[1][("fused_ce", arch)]
    assert _rel(got["loss"], ref["loss"]) <= ATOL
    for k in ("hidden", "table"):
        np.testing.assert_allclose(got["grads"][k].numpy(), ref[k].numpy(),
                                   atol=ATOL)


def test_fp8_gather_matches_emulation(world_a, cases):
    got = world_a[("fp8_gather", FP8_ARCH)]["metrics"]["loss"]
    ref = cases[1][("fp8_gather", FP8_ARCH)]
    assert abs(got - ref["emulated"][0]) <= ATOL * abs(ref["emulated"][0])
    assert _rel(got, ref["plain"][0]) <= FP8_REL
    assert got != ref["plain"][0], "the gather was not quantised"
    # the 1e-5 limit tells a quantised gather from an unquantised one
    assert abs(ref["plain"][0] - ref["emulated"][0]) > \
        ATOL * abs(ref["emulated"][0])


def _e4m3(t):
    return t.to(torch.float8_e4m3fn).to(t.dtype)


@pytest.mark.parametrize("world", ["a", "b"])
def test_fp8_gather_rounds_weight_and_cotangent(world_a, world_b, cases,
                                                world):
    """The gather's forward is the e4m3 cast; its backward rounds each
    rank's cotangent to e4m3, sums over the FSDP axes (the ranks of the
    same ``model`` index) and keeps the rank's shard of ``dim``."""
    case = cases[0][("fp8_gather_op", "experts")]
    got = (world_a if world == "a" else world_b)[("fp8_gather_op",
                                                  "experts")]
    n_shards = len(got) // len({p[0] for p in got})
    assert n_shards > 1
    rounded = _e4m3(case["g"])
    assert not torch.allclose(rounded, case["g"], atol=ATOL, rtol=0)
    for tp_i, f_i, out, gw in got:
        assert torch.equal(out, _e4m3(case["w"]))
        peers = [r for r, p in enumerate(got) if p[0] == tp_i]
        assert len(peers) == n_shards
        want = rounded[peers].sum(0).chunk(n_shards, case["dim"])[f_i]
        torch.testing.assert_close(gw, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("world", ["a", "b"])
def test_weight_stationary_decode(world_a, world_b, world):
    got = world_a if world == "a" else world_b
    ws, base = got[("weight_stationary", WS_ARCH)], got[("default", WS_ARCH)]
    assert torch.equal(ws["tokens"], base["tokens"])
    for a, b in zip(ws["logits"], base["logits"]):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["one_rank_holds_keys",
                                  "last_shards_empty"])
@pytest.mark.parametrize("world", ["a", "b"])
def test_island_merges_empty_shards_without_nan(world_a, world_b, cases,
                                                world, case):
    got = (world_a if world == "a" else world_b)[("island", case)]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, _island_ref(cases[0][("island", case)]),
                               atol=ATOL, rtol=0)


def test_chunked_attention_stats_match_reference():
    rng = np.random.RandomState(0)
    q = rng.randn(2, 1, 4, 16).astype(np.float32)
    k = rng.randn(2, 40, 2, 16).astype(np.float32)
    v = rng.randn(2, 40, 2, 16).astype(np.float32)
    kpos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    qoff = np.array([17, 39], np.int32)
    kw = dict(causal=True, kv_chunk=16, return_stats=True)
    want = jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       q_offset=jnp.asarray(qoff),
                       k_positions=jnp.asarray(kpos),
                       k_valid=jnp.asarray(kpos < 30), **kw)
    got = chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v),
                            q_offset=torch.from_numpy(qoff),
                            k_positions=torch.from_numpy(kpos.copy()),
                            k_valid=torch.from_numpy(kpos < 30), **kw)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


def test_every_flag_is_accepted():
    dist = DistContext({"data": 2, "model": 4}, flags=FLAGS)
    assert all(dist.has(f) for f in FLAGS)
    with pytest.raises(ValueError):
        DistContext({"data": 2, "model": 4}, flags=frozenset({"nope"}))
