"""The port's serving path against the JAX reference, on the CPU.

* The plain flash-decode versions (what a CPU tensor runs) against the
  JAX Pallas kernels in interpret mode, the JAX XLA twins and a naive
  oracle, on the cases of ``tests/test_serve.py``, at atol 2e-5.
* The port's ``ServeEngine`` (chunked and flash, dense and paged) must give
  greedy tokens equal to the JAX ``ServeEngine`` with
  ``decode_kernel="chunked"``, including evict/resume, stalled slots and
  the gemma3 ring + paged hybrid; the reference's rejections hold.
* One ``serve_pipeline`` campaign through both packages' ``KsaCluster``.

JAX weights are carried across with ``tree_to_torch``. The JAX reference
tokens come from one jitted engine per config, built once per module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _flash_decode_cases import ATOL_F32, CASES, oracle
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import flash_decode as jfd
from repro.models import init_params as jax_init_params
from repro.models import model_spec as jax_model_spec
from repro.serve import ServeEngine as JaxEngine
from repro_torch.configs import smoke_config
from repro_torch.convert import tree_to_torch
from repro_torch.kernels import flash_decode as tfd
from repro_torch.serve import ServeEngine, ServeReplicaSet, serve_pipeline


# ---------------------------------------------------------------------------
# kernels: the plain versions against JAX
# ---------------------------------------------------------------------------


def _jax_outputs(case):
    """The JAX Pallas kernel (interpret mode) and XLA twin on the case."""
    q = jnp.asarray(case["q"])
    k, v = jnp.asarray(case["k"]), jnp.asarray(case["v"])
    qpos = jnp.asarray(case["qpos"])
    if case["kind"] == "paged":
        table = jnp.asarray(case["table"])
        kw = dict(window=case["window"])
        return {"pallas": jfd.flash_decode_paged(q, k, v, qpos, table,
                                                 interpret=True, **kw),
                "xla": jfd.flash_decode_paged_xla(q, k, v, qpos, table, **kw)}
    kpos = jnp.asarray(case["kpos"])
    kw = dict(window=case["window"], block_k=case["block_k"])
    return {"pallas": jfd.flash_decode(q, k, v, qpos, kpos, interpret=True,
                                       **kw),
            "xla": jfd.flash_decode_xla(q, k, v, qpos, kpos,
                                        bounded=case["bounded"], **kw)}


def _torch_plain(case, **kw):
    t = {n: torch.from_numpy(case[n]) for n in ("q", "k", "v", "qpos")}
    if case["kind"] == "paged":
        return tfd.flash_decode_paged_ref(
            t["q"], t["k"], t["v"], t["qpos"], torch.from_numpy(case["table"]),
            window=case["window"], **kw)
    kw.setdefault("bounded", case["bounded"])
    return tfd.flash_decode_ref(
        t["q"], t["k"], t["v"], t["qpos"], torch.from_numpy(case["kpos"]),
        window=case["window"], block_k=case["block_k"], **kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_kernels(name):
    case = CASES[name]()
    got = _torch_plain(case).numpy()
    want = oracle(case)
    np.testing.assert_allclose(got, want, atol=ATOL_F32)
    for which, out in _jax_outputs(case).items():
        np.testing.assert_allclose(got, np.asarray(out), atol=ATOL_F32,
                                   err_msg=which)
    assert np.isfinite(got).all()
    for lane in case["empty"]:
        np.testing.assert_array_equal(got[lane], 0.0)


@pytest.mark.parametrize("name", ["causal_ragged_kh2", "paged"])
def test_plain_unbounded_equals_bounded(name):
    case = CASES[name]()
    np.testing.assert_allclose(_torch_plain(case, bounded=False).numpy(),
                               _torch_plain(case).numpy(), atol=1e-6)


def test_wrappers_take_plain_version_on_cpu():
    """A CPU tensor runs the plain version and launches nothing."""
    before = (tfd.flash_decode.launches, tfd.flash_decode_paged.launches)
    for name in ("window", "paged"):
        case = CASES[name]()
        t = {n: torch.from_numpy(case[n]) for n in ("q", "k", "v", "qpos")}
        if case["kind"] == "paged":
            got = tfd.decode_attention_paged(
                t["q"], t["k"], t["v"], t["qpos"],
                torch.from_numpy(case["table"]), window=case["window"])
        else:
            got = tfd.decode_attention(
                t["q"], t["k"], t["v"], t["qpos"],
                torch.from_numpy(case["kpos"]), window=case["window"],
                block_k=case["block_k"])
        torch.testing.assert_close(got, _torch_plain(case), atol=0, rtol=0)
    assert (tfd.flash_decode.launches,
            tfd.flash_decode_paged.launches) == before


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(2, 1, 3, 8)
    k = torch.zeros(2, 16, 2, 8)
    with pytest.raises(ValueError):
        tfd.flash_decode(q, k, k, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        tfd.flash_decode(torch.zeros(2, 2, 4, 8), k, k,
                         torch.zeros(2, dtype=torch.int32))


# ---------------------------------------------------------------------------
# engine parity: one JAX reference engine per config, built once
# ---------------------------------------------------------------------------

def _prompts(seed, vocab, lengths):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, vocab, n)] for n in lengths]


VOCAB = 512   # both smoke configs


REQUESTS = {
    # (arch, request id): (prompt, max_new); the cases of tests/test_serve.py
    **{("stablelm_1_6b", f"p{i}"): (p, 4) for i, p in
       enumerate(_prompts(3, VOCAB, [4 + 2 * i for i in range(4)]))},
    **{("stablelm_1_6b", f"f{i}"): (p, 4) for i, p in
       enumerate(_prompts(4, VOCAB, [5 + i for i in range(3)]))},
    **{("gemma3_1b", f"g{i}"): (p, 4) for i, p in
       enumerate(_prompts(5, VOCAB, [6 + 3 * i for i in range(3)]))},
    ("stablelm_1_6b", "victim"): (_prompts(7, VOCAB, [6, 4])[0], 8),
    ("stablelm_1_6b", "other"): (_prompts(7, VOCAB, [6, 4])[1], 10),
    **{(arch, rid): (p, 20) for arch in ("stablelm_1_6b", "gemma3_1b",
                                         "recurrentgemma_2b")
       for rid, p in zip("ab", _prompts(9, VOCAB, [4, 4]))},
    **{("stablelm_1_6b", f"q{i}"): (p, 5) for i, p in
       enumerate(_prompts(8, VOCAB, [4 + i for i in range(8)]))},
}
SEEDS = {"stablelm_1_6b": 0, "gemma3_1b": 2, "recurrentgemma_2b": 5}


@pytest.fixture(scope="module")
def reference():
    """Per config: the JAX and the torch weights, and the JAX engine's
    greedy tokens for every request of this module."""
    out = {}
    for arch, seed in SEEDS.items():
        cfg = jax_smoke_config(arch)
        params = jax_init_params(jax_model_spec(cfg),
                                 jax.random.PRNGKey(seed), jnp.float32)
        eng = JaxEngine(cfg, params, n_slots=8, max_len=64,
                        decode_kernel="chunked")
        reqs = [(rid, list(p), n) for (a, rid), (p, n) in REQUESTS.items()
                if a == arch]
        tokens = eng.run_until_drained(reqs)
        assert set(tokens) == {rid for rid, _, _ in reqs}
        out[arch] = dict(jax_params=params, jax_engine=eng, tokens=tokens,
                         params=tree_to_torch(jax.tree.map(np.asarray,
                                                           params), "cpu"))
    return out


def _engine(reference, arch, **kw):
    kw.setdefault("device", "cpu")
    return ServeEngine(smoke_config(arch), reference[arch]["params"],
                       n_slots=2, max_len=64, **kw)


def _reqs(arch, prefix):
    return [(rid, list(p), n) for (a, rid), (p, n) in REQUESTS.items()
            if a == arch and rid.startswith(prefix)]


def _drain_and_check(reference, arch, eng, reqs):
    out = eng.run_until_drained(list(reqs))
    assert set(out) == {rid for rid, _, _ in reqs}
    for rid, _, _ in reqs:
        assert out[rid] == reference[arch]["tokens"][rid], rid


@pytest.mark.parametrize("kernel", ["chunked", "flash"])
def test_paged_engine_matches_reference(reference, kernel):
    eng = _engine(reference, "stablelm_1_6b", paged=True, page_size=16,
                  decode_kernel=kernel)
    _drain_and_check(reference, "stablelm_1_6b", eng,
                     _reqs("stablelm_1_6b", "p"))
    assert eng.allocator.used_pages == 0  # all pages returned
    eng.allocator.check()


@pytest.mark.parametrize("kernel", ["chunked", "flash"])
def test_flash_engine_matches_reference(reference, kernel):
    eng = _engine(reference, "stablelm_1_6b", decode_kernel=kernel)
    _drain_and_check(reference, "stablelm_1_6b", eng,
                     _reqs("stablelm_1_6b", "f"))


@pytest.mark.parametrize("paged", [False, True])
def test_flash_paged_engine_hybrid_arch(reference, paged):
    """gemma3 mixes ring local layers (dense flash path, unbounded) with
    global attention layers (paged flash path) in one stack."""
    eng = _engine(reference, "gemma3_1b", paged=paged, page_size=16,
                  decode_kernel="flash")
    _drain_and_check(reference, "gemma3_1b", eng, _reqs("gemma3_1b", "g"))


def test_evict_and_resume_mid_generation(reference):
    """Evicting a request mid-generation and re-admitting it (on a paged
    engine) must reproduce the uninterrupted greedy decode exactly."""
    arch = "stablelm_1_6b"
    prompt, _ = REQUESTS[(arch, "victim")]
    other, _ = REQUESTS[(arch, "other")]
    eng = _engine(reference, arch, paged=True, page_size=16,
                  decode_kernel="flash")
    assert eng.add_request("victim", prompt, max_new=8)
    assert eng.add_request("other", other, max_new=10)
    done = {}
    for _ in range(len(prompt) + 3):  # victim is 3 tokens into generation
        done.update(eng.step())
    state = eng.evict("victim")
    assert state is not None and state["prompt"] == prompt
    assert 0 < len(state["tokens"]) < 8
    eng.allocator.check()
    assert eng.add_request("victim", state["prompt"], state["max_new"],
                          resume_tokens=state["tokens"])
    while eng._active():
        done.update(eng.step())
    want = reference[arch]["tokens"]
    assert done["victim"] == want["victim"]
    assert done["other"] == want["other"]


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "gemma3_1b",
                                  "recurrentgemma_2b"])
def test_stalled_slot_resumes_uncorrupted(reference, arch):
    """Page-pool exhaustion stalls one slot while the other keeps stepping.
    The stalled slot rides the step as a garbage lane; the port writes
    caches in place, so its ring K/V lanes must be saved and restored —
    it must resume bit-exact against the uninterrupted greedy decode."""
    eng = _engine(reference, arch, paged=True, page_size=16, n_pages=4,
                  decode_kernel="flash")
    reqs = [(rid, *REQUESTS[(arch, rid)]) for rid in "ab"]
    for req in reqs:
        assert eng.add_request(*req)
    done, stalls = {}, 0
    for _ in range(200):
        before = {i: eng.slots[i].position for i in eng._active()}
        done.update(eng.step())
        stalls += sum(1 for i, p in before.items()
                      if not eng.slots[i].done
                      and eng.slots[i].position == p)
        if not eng._active():
            break
    assert stalls > 0  # the scenario really exercised a stall
    eng.allocator.check()
    assert eng.allocator.used_pages == 0
    for rid, _, _ in reqs:
        assert done[rid] == reference[arch]["tokens"][rid], rid


def test_stall_rollback_restores_ring_lanes(reference):
    """The step writes caches in place; a stalled slot's ring lane must
    come back equal to its pre-step copy (without the rollback, row 0 would
    hold the garbage lane's K/V)."""
    eng = _engine(reference, "gemma3_1b", paged=True, page_size=2, n_pages=4)
    assert eng.add_request("x", [1, 2, 3], max_new=30)
    assert eng.add_request("y", [4, 5, 6], max_new=30)
    eng.step()
    eng.step()                      # both slots at position 2, one page each
    ring = eng.caches["periods"]["0"]["k"]
    before = ring[:, 1].clone()
    eng.step()                      # x takes the last page, y stalls
    assert [s.position for s in eng.slots] == [3, 2]
    torch.testing.assert_close(ring[:, 1], before, atol=0, rtol=0)


def test_reset_full_rejects_paged(reference):
    with pytest.raises(ValueError):
        _engine(reference, "stablelm_1_6b", paged=True,
                admission="reset_full")


def test_reset_full_matches_reference(reference):
    arch = "stablelm_1_6b"
    eng = _engine(reference, arch, admission="reset_full")
    _drain_and_check(reference, arch, eng, _reqs(arch, "f"))


def test_oversized_prompt_rejected(reference):
    cfg = smoke_config("stablelm_1_6b")
    params = reference["stablelm_1_6b"]["params"]
    eng = ServeEngine(cfg, params, n_slots=1, max_len=16, paged=True,
                      page_size=8, device="cpu")
    with pytest.raises(ValueError):
        eng.add_request("big", list(range(16)), max_new=4)
    with pytest.raises(ValueError):
        eng.add_request("big", list(range(10)), max_new=4,
                        resume_tokens=list(range(6)))
    assert eng.add_request("fits", list(range(15)), max_new=4)
    rs = ServeReplicaSet(cfg, params, n_replicas=1,
                         engine_kw=dict(n_slots=1, max_len=16, device="cpu"))
    with pytest.raises(ValueError):
        rs.submit("big", list(range(16)))
    assert rs.lost == 0 and rs.submitted == 0


def test_replica_set_completes_all_zero_lost(reference):
    """Two port engines behind the copied router: every request completes
    once, on both replicas, with the JAX engine's tokens."""
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve import register_serve_metrics
    arch = "stablelm_1_6b"
    reg = MetricsRegistry()
    rs = ServeReplicaSet(smoke_config(arch), reference[arch]["params"],
                         n_replicas=2, registry=reg,
                         engine_kw=dict(n_slots=2, max_len=64, paged=True,
                                        page_size=16, decode_kernel="flash",
                                        device="cpu"))
    reqs = _reqs(arch, "q")
    with rs:
        pend = [rs.submit(rid, prompt, max_new=n) for rid, prompt, n in reqs]
        assert rs.drain(timeout=120)
    assert rs.completed == len(reqs) and rs.lost == 0 and rs.duplicates == 0
    assert sorted({p.replica for p in pend}) == [0, 1]
    for p, (rid, _, _) in zip(pend, reqs):
        assert p.tokens == reference[arch]["tokens"][rid], rid
    fam = register_serve_metrics(reg)["tokens"]
    assert sum(child.value for _, child in fam.items()) >= 5 * len(reqs)


def test_engine_asks_for_cuda_by_default(reference):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    with pytest.raises(RuntimeError):
        ServeEngine(smoke_config("stablelm_1_6b"),
                    reference["stablelm_1_6b"]["params"], n_slots=1,
                    max_len=16)


# ---------------------------------------------------------------------------
# one serving campaign through both packages' KsaCluster
# ---------------------------------------------------------------------------


def _serve_campaign(cluster_cls, profile_cls, request_cls, pipeline_fn,
                    engine, texts):
    request_cls.engine = engine
    try:
        with cluster_cls(workers=1, poll_interval_s=0.01) as c:
            c.add_worker(slots=1, profile=profile_cls(cpus=2, gpus=1,
                                                      mem_mb=4096))
            res = c.run_campaign(pipeline_fn(batch_size=2, vocab_size=VOCAB,
                                             max_new=5), texts,
                                 timeout_s=240.0)
    finally:
        request_cls.engine = None
    assert res.status.state == "COMPLETED"
    return res.final


def test_serve_pipeline_matches_reference(reference):
    from repro.cluster import KsaCluster as JaxCluster
    from repro.core import ResourceProfile as JaxProfile
    from repro.serve import serve_pipeline as jax_pipeline
    from repro.serve.engine import ServeRequestComputing as JaxRequest
    from repro_torch.cluster import KsaCluster
    from repro_torch.core import ResourceProfile
    from repro_torch.serve.engine import ServeRequestComputing

    texts = [{"id": f"t{i}", "text": f"fold protein number {i} " * (1 + i % 2)}
             for i in range(4)]
    want = _serve_campaign(JaxCluster, JaxProfile, JaxRequest, jax_pipeline,
                           reference["stablelm_1_6b"]["jax_engine"], texts)
    got = _serve_campaign(KsaCluster, ResourceProfile, ServeRequestComputing,
                          serve_pipeline,
                          _engine(reference, "stablelm_1_6b", paged=True,
                                  page_size=16, decode_kernel="flash"),
                          texts)
    assert got["n_requests"] == want["n_requests"] == 4
    assert got["responses"] == want["responses"]
    assert got["total_tokens"] == want["total_tokens"] == 20


@pytest.mark.parametrize("paged", [False, True])
def test_engine_serves_mamba2(paged):
    """The Mamba-2 smoke config (SSD layers: prompts fed a token a step go
    through ``ssd_step`` and the conv state) through the port's engine with
    2 slots gives the JAX engine's greedy tokens; slots are reused, so the
    per-slot recurrent state is reset on admission."""
    jcfg = jax_smoke_config("mamba2_130m")
    params = jax_init_params(jax_model_spec(jcfg), jax.random.PRNGKey(4),
                             jnp.float32)
    reqs = [(f"m{i}", p, 6) for i, p in
            enumerate(_prompts(1, VOCAB, [4 + 3 * i for i in range(5)]))]
    want = JaxEngine(jcfg, params, n_slots=8, max_len=64,
                     decode_kernel="chunked").run_until_drained(list(reqs))
    eng = ServeEngine(smoke_config("mamba2_130m"),
                      tree_to_torch(jax.tree.map(np.asarray, params), "cpu"),
                      n_slots=2, max_len=64, device="cpu", paged=paged,
                      page_size=16)
    assert eng.run_until_drained(list(reqs)) == want
