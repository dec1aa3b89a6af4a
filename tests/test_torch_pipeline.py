"""The port's pipeline-parallel serving against the JAX package's, on the
CPU: the stage partition (the same bounds, errors and stage leaves), the
composed stage forwards (equal to the port's monolithic packed forward
bit for bit, and to JAX's composed stages at 5e-4), ``Server(pp=4)``
greedy tokens equal to ``pp=1`` and to the JAX ``PipelineEngine``'s,
stochastic sampling equal across ``pp``, the pipelined online loop on
durations computed from the plans (the JAX loop's records exactly), swap
and the prefix cache across stages, and the refusal of what is still
unported.  No Hypothesis: every case is a parametrised example."""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import serving as jserving  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import Engine as JaxEngine  # noqa: E402
from repro.launch import pipeline as jpl  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import make_packed as jax_make_packed  # noqa: E402
from repro.scheduler import Request as JaxRequest  # noqa: E402
from repro.scheduler import request as jax_request_mod  # noqa: E402
from repro.serving.server import \
    build_engine_and_scheduler as jax_build  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Engine, PipelineEngine, SamplingParams  # noqa
from repro_torch.core.engine import _pool_leaves  # noqa: E402
from repro_torch.launch import pipeline as pl  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import make_packed, stack  # noqa: E402
from repro_torch.scheduler import Request  # noqa: E402
from repro_torch.scheduler import request as request_mod  # noqa: E402
from repro_torch.serving.convert import (from_jax_tree,  # noqa: E402
                                         jax_tree_to_state)

# tests/test_pipeline_engine.py's model: reduced tinyllama, 4 layers, d 32
SHAPE = dict(n_layers=4, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
             d_ff=64, vocab_size=64)
TOL = dict(rtol=5e-4, atol=5e-4)
GEOM = dict(chunk_size=8, n_slots=4, max_len=64, block_size=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast, and keeps the suite's
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch="tinyllama-1.1b"):
    """(JAX cfg, JAX params, port cfg, port params carried across)."""
    cfg_j = dataclasses.replace(jax_config(arch).reduced(), **SHAPE)
    params_j = jax_build_model(cfg_j).init_params(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config(arch).reduced(), **SHAPE)
    return cfg_j, params_j, cfg, from_jax_tree(
        cfg, jax.device_get(params_j), device="cpu")


def _reqs(request_cls, mod, seed=0, n=5, rate=None, online=None):
    """tests/test_pipeline_engine.py's workloads: ``n`` prompts of 6-20
    tokens, 3-6 new tokens each, all at 0; or ``online``'s
    ``online_workload`` at ``rate``."""
    mod._ids = itertools.count()                  # deterministic req ids
    if rate is not None:
        return online.online_workload(n, rate=rate, pd_ratio=4.0,
                                      min_len=6, max_len=20,
                                      vocab_size=SHAPE["vocab_size"],
                                      seed=seed)
    rng = np.random.default_rng(seed)
    return [request_cls(prompt=[int(t) for t in rng.integers(
                0, SHAPE["vocab_size"], int(rng.integers(6, 21)))],
                        max_new_tokens=int(rng.integers(3, 7)))
            for _ in range(n)]


# --------------------------------------------------------------------------
# (1) the stage partition
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_groups", range(1, 13))
def test_stage_bounds_match_jax(n_groups):
    for pp in range(1, n_groups + 1):
        assert pl.stage_bounds(n_groups, pp) == \
            jpl.stage_bounds(n_groups, pp)
    for pp in (0, n_groups + 1):
        with pytest.raises(ValueError) as want:
            jpl.stage_bounds(n_groups, pp)
        with pytest.raises(ValueError) as got:
            pl.stage_bounds(n_groups, pp)
        assert str(got.value).split(";")[0] == \
            str(want.value).split(";")[0]


def _stage_state(sp: stack.StageParams):
    """A stage view's tensors under the converter's names."""
    out = {k: getattr(sp, k).detach().numpy()
           for k in ("embed", "final_norm", "unembed")
           if getattr(sp, k) is not None}
    for j, layer in enumerate(sp.layers):
        for name, p in layer.named_parameters():
            out[f"layers.{j}.{name}"] = p.detach().numpy()
    return out


@pytest.mark.parametrize("pp", [1, 2, 3, 4])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-0.5b"])
def test_stage_leaves_match_jax(arch, pp):
    """``stage_params``/``stage_cache`` put the same leaves on the same
    stages as JAX's (qwen2 ties its embeddings: the last stage carries
    ``embed`` again), and the port's stages are views: the model's own
    modules, tensors and cache dicts."""
    cfg_j, params_j, cfg, params = _models(arch)
    got = pl.stage_params(cfg, params, pp)
    want = jpl.stage_params(cfg_j, jax.device_get(params_j), pp)
    assert len(got) == len(want) == pp
    layer = 0
    for sp, tree in zip(got, want):
        state = _stage_state(sp)
        want_state = jax_tree_to_state(tree)
        assert sorted(state) == sorted(want_state)
        for name, arr in want_state.items():
            np.testing.assert_array_equal(state[name], arr)
        for mod in sp.layers:
            assert mod is params.layers[layer]
            layer += 1
        for k in ("embed", "final_norm", "unembed"):
            assert getattr(sp, k) is None or getattr(sp, k) is \
                getattr(params, k)
    assert layer == cfg.n_layers

    for kw in ({}, dict(paged_blocks=6, block_size=8)):
        jcache = jax_build_model(cfg_j).init_cache(3, 32, **kw)
        cache = build_model(cfg).init_cache(3, 32, device="cpu", **kw)
        jstages = jpl.stage_cache(cfg_j, jcache, pp)
        stages = pl.stage_cache(cfg, cache, pp)
        assert len([c for s in stages for c in s]) == len(cache)
        assert all(a is b for a, b in zip([c for s in stages for c in s],
                                          cache))
        for mine, theirs in zip(stages, jstages):
            leaves = jax.tree.leaves(theirs["groups"])
            assert {leaf.shape[0] for leaf in leaves} == {len(mine)}
            for layer_cache in mine:
                shapes = sorted(tuple(t.shape) for part in
                                layer_cache.values() for t in part.values())
                assert shapes == sorted(leaf.shape[1:] for leaf in leaves)
            assert not theirs.get("tail")


# --------------------------------------------------------------------------
# (2) the composed stage forwards
# --------------------------------------------------------------------------
def _steps(rng, vocab):
    """tests/test_torch_models.py's three packed steps on two requests
    with two decode lanes (the second always unused)."""
    a = rng.integers(0, vocab, 8).tolist()
    b = rng.integers(0, vocab, 13).tolist()
    tok = int(rng.integers(0, vocab))
    return [
        dict(chunk_tokens=a, chunk_slot=0, chunk_start=0, chunk_len=8,
             decode_tokens=[0, 0], decode_slots=[2, 2], decode_ctx=[0, 0],
             chunk_blocks=[1, 2, 0, 0], decode_blocks=[[0] * 4] * 2),
        dict(chunk_tokens=b[:8], chunk_slot=1, chunk_start=0, chunk_len=8,
             decode_tokens=[tok, 0], decode_slots=[0, 2], decode_ctx=[8, 0],
             chunk_blocks=[3, 4, 0, 0], decode_blocks=[[1, 2, 0, 0],
                                                       [0] * 4]),
        dict(chunk_tokens=b[8:] + [0, 0, 0], chunk_slot=1, chunk_start=8,
             chunk_len=5, decode_tokens=[tok, 0], decode_slots=[0, 2],
             decode_ctx=[9, 0], chunk_blocks=[3, 4, 0, 0],
             decode_blocks=[[1, 2, 0, 0], [0] * 4]),
    ]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("pp", [1, 2, 3, 4])
def test_composed_stages_equal_forward_packed(pp, paged):
    """The port's stages composed in order give its monolithic
    ``forward_packed``'s logits and cache exactly, and JAX's composed
    ``forward_packed_stage`` logits at 5e-4 (the chunk row and the real
    decode lanes), over three packed steps."""
    cfg_j, params_j, cfg, params = _models()
    jmodel, model = jax_build_model(cfg_j), build_model(cfg)
    kw = dict(paged_blocks=6, block_size=8) if paged else {}
    whole = model.init_cache(3, 32, device="cpu", **kw)
    cache = model.init_cache(3, 32, device="cpu", **kw)
    stages = pl.stage_cache(cfg, cache, pp)
    sp = pl.stage_params(cfg, params, pp)
    jstages = jpl.stage_cache(cfg_j, jmodel.init_cache(3, 32, **kw), pp)
    jsp = jpl.stage_params(cfg_j, params_j, pp)
    for i, step in enumerate(_steps(np.random.default_rng(4),
                                    cfg.vocab_size)):
        if not paged:
            step = dict(step, chunk_blocks=[], decode_blocks=[[], []])
        pk = make_packed(**step)
        with torch.inference_mode():
            want_c, want_d, _, _ = model.forward_packed(params, pk, whole)
            x = None
            for s in range(pp):
                x, _, _ = model.forward_packed_stage(
                    sp[s], pk, stages[s], x, first=s == 0,
                    last=s == pp - 1)
        assert torch.equal(x[0], want_c) and torch.equal(x[1], want_d)
        for a, b in zip(whole, cache):
            for part_a, part_b in zip(a.values(), b.values()):
                for key in part_a:
                    assert torch.equal(part_a[key], part_b[key])

        jpk, jx = jax_make_packed(**step), None
        for s in range(pp):
            jx, jstages[s], _ = jmodel.forward_packed_stage(
                jsp[s], jpk, jstages[s], jx, first=s == 0,
                last=s == pp - 1)
        np.testing.assert_allclose(x[0].numpy(), np.asarray(jx[0]), **TOL)
        n_real = 0 if i == 0 else 1
        np.testing.assert_allclose(x[1][:n_real].numpy(),
                                   np.asarray(jx[1][:n_real]), **TOL)


# --------------------------------------------------------------------------
# (3) and (4) offline serving: pp=4 == pp=1 == JAX pp=4
# --------------------------------------------------------------------------
def _serve(server_cls, request_cls, mod, cfg, params, workload_seed=0,
           **kw):
    srv = server_cls(cfg, params, **GEOM, **kw)
    reqs = _reqs(request_cls, mod, seed=workload_seed)
    res = srv.run(reqs)
    return ([res.outputs[r.req_id] for r in reqs],
            [(i.n_prefill_tokens, i.n_decode_tokens)
             for i in res.iterations]), srv.engine


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("policy", ["sarathi", "sarathi_serve"])
def test_server_pp4_matches_pp1_and_jax(policy, paged):
    """Greedy tokens and plans of the port's ``Server(pp=4)`` equal its
    ``pp=1`` run's and the JAX ``Server(pp=4)``'s (sarathi_serve's token
    budget makes multi-chunk plans: several sub-steps an iteration)."""
    cfg_j, params_j, cfg, params = _models()
    kw = dict(policy=policy, paged=paged)
    if policy == "sarathi_serve":
        kw["token_budget"] = 20
    want, _ = _serve(jserving.Server, JaxRequest, jax_request_mod, cfg_j,
                     params_j, pp=4, **kw)
    one, eng1 = _serve(serving.Server, Request, request_mod, cfg, params,
                       device="cpu", **kw)
    four, eng4 = _serve(serving.Server, Request, request_mod, cfg, params,
                        pp=4, device="cpu", **kw)
    assert type(eng1) is Engine and isinstance(eng4, PipelineEngine)
    assert eng4.pp == 4 and len(eng4.stage_caches) == 4
    assert four == one == want
    assert all(len(out) > 0 for out in four[0])
    assert eng4.iterations == eng1.iterations


@pytest.mark.parametrize("paged", [False, True])
def test_stochastic_sampling_pp4_equals_pp1(paged):
    """temperature 1: the engine's one generator advances per packed
    sub-step in the same order at every ``pp``; a warmed engine replays a
    cold one."""
    _, _, cfg, params = _models()
    kw = dict(policy="sarathi", paged=paged, seed=7,
              sampling=SamplingParams(temperature=1.0))
    outs = [_serve(serving.Server, Request, request_mod, cfg, params,
                   workload_seed=1, pp=pp, device="cpu", **kw)[0]
            for pp in (1, 4)]
    srv = serving.Server(cfg, params, **GEOM, pp=4, device="cpu", **kw)
    srv.engine.warmup()
    reqs = _reqs(Request, request_mod, seed=1)
    res = srv.run(reqs)
    assert outs[0] == outs[1]
    assert outs[0][0] == [res.outputs[r.req_id] for r in reqs]


def test_force_pipeline_builds_one_stage_pipeline():
    """``force_pipeline`` serves on a one-stage PipelineEngine through the
    pipelined loop, which at ``pp=1`` is the serial loop: the same plans
    and tokens as the plain engine's."""
    _, _, cfg, params = _models()
    eng, _ = serving.build_engine_and_scheduler(
        cfg, params, policy="sarathi", force_pipeline=True, device="cpu",
        **GEOM)
    assert isinstance(eng, PipelineEngine) and eng.pp == 1
    runs = []
    for forced in (False, True):
        srv = serving.OnlineServer(cfg, params, **GEOM, device="cpu",
                                   force_pipeline=forced)
        reqs = _reqs(Request, request_mod)
        res = srv.run(reqs)
        assert isinstance(srv.engine, PipelineEngine) == forced
        assert (res.pipeline is not None) == forced
        runs.append(([res.outputs[r.req_id] for r in reqs],
                     [(i.n_prefill_tokens, i.n_decode_tokens)
                      for i in res.iterations]))
    assert runs[0] == runs[1]
    assert all(len(out) > 0 for out in runs[1][0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activation_bytes_match_jax(dtype):
    import jax.numpy as jnp
    cfg_j, params_j, cfg, params = _models()
    kw = dict(n_slots=4, max_len=64, chunk_size=8, decode_slots=3)
    want = JaxEngine(cfg_j, params_j, dtype=getattr(jnp, dtype),
                     **kw).activation_bytes_per_iteration()
    got = PipelineEngine(cfg, params, pp=2, dtype=getattr(torch, dtype),
                         device="cpu", **kw)
    assert got.activation_bytes_per_iteration() == want
    assert Engine(cfg, params, dtype=getattr(torch, dtype), device="cpu",
                  **kw).activation_bytes_per_iteration() == want


# --------------------------------------------------------------------------
# (5) the pipelined online loop on plan-derived durations
# --------------------------------------------------------------------------
def _plan_durations(engine):
    """Make ``execute_timed`` return durations computed from the plan
    (1 ms a token, stage s (1 + s / 4) times as long), not wall time, so
    that the lock pattern is deterministic."""
    def timed(plan):
        tokens = engine.execute(plan)
        n = plan.n_prefill_tokens + plan.n_decode_tokens
        return tokens, [1e-3 * n * (1 + s / 4) for s in range(engine.pp)]

    engine.execute_timed = timed


def _pipelined(online, build, request_cls, mod, cfg, params, pp, policy,
               paged, **kw):
    engine, sched = build(
        cfg, params, policy=policy, pp=pp, paged=paged, max_decodes=2,
        max_prompt_len=24, **GEOM, **kw)
    _plan_durations(engine)
    reqs = _reqs(request_cls, mod, seed=6, n=7, rate=48.0, online=online)
    res = online.serve_online_pipelined(sched, engine, reqs)
    st = res.pipeline
    return ([dataclasses.astuple(i) for i in res.iterations],
            [dataclasses.astuple(res.traces[r.req_id])[1:] for r in reqs],
            [res.outputs[r.req_id] for r in reqs], res.makespan,
            (st.pp, st.stage_free, st.stage_busy, st.n_microbatches,
             st.bubble_fraction), repr(dataclasses.astuple(res.summary())))


@pytest.mark.parametrize("policy,pp,paged", [
    ("sarathi_serve", 2, False), ("sarathi_serve", 4, True),
    ("sarathi", 2, True), ("orca", 4, False)])
def test_pipelined_loop_matches_jax(policy, pp, paged):
    """``serve_online_pipelined`` over each package's PipelineEngine, on
    the same plan-derived stage durations: the same iteration records,
    token times, outputs, pipeline ledger and summary."""
    cfg_j, params_j, cfg, params = _models()
    kw = ({"policy_kwargs": {"max_chunks_per_iter": 1}}
          if policy == "sarathi_serve" else {})
    want = _pipelined(jserving, jax_build, JaxRequest, jax_request_mod,
                      cfg_j, params_j, pp, policy, paged, **kw)
    got = _pipelined(serving, serving.build_engine_and_scheduler, Request,
                     request_mod, cfg, params, pp, policy, paged,
                     device="cpu", **kw)
    assert got == want
    assert got[4][3] == len(got[0]) > 0
    assert 0.0 < got[4][4] < 1.0


def test_online_server_dispatches_to_the_pipelined_loop():
    """``OnlineServer(pp=2)`` runs the pipelined loop: every request gets
    its tokens on the pipeline clock, with a bubble ledger."""
    _, _, cfg, params = _models()
    reqs = _reqs(Request, request_mod, seed=4, n=6, rate=64.0,
                 online=serving)
    kw = dict(policy="sarathi_serve", device="cpu",
              policy_kwargs={"max_chunks_per_iter": 1})
    res = serving.OnlineServer(cfg, params, **GEOM, pp=2, **kw).run(reqs)
    for r in reqs:
        assert len(res.outputs[r.req_id]) == r.max_new_tokens
    st = res.pipeline
    assert st.pp == 2 and st.n_microbatches == len(res.iterations)
    assert all(b > 0 for b in st.stage_busy)
    assert res.makespan == st.makespan
    assert res.summary().bubble_fraction == st.bubble_fraction


# --------------------------------------------------------------------------
# (6) swap and the prefix cache across stages
# --------------------------------------------------------------------------
def test_pipeline_swap_round_trip_in_place():
    """pp=2: swap three blocks out, clobber them, swap them in to other
    blocks; on every stage the bytes come back, no other block changes,
    every pool leaf keeps its address, and each leaf has its own arena."""
    _, _, cfg, params = _models()
    eng = PipelineEngine(cfg, params, pp=2, n_slots=2, max_len=64,
                         chunk_size=8, decode_slots=1, paged=True,
                         block_size=8, n_blocks=12, host_blocks=6,
                         device="cpu")
    leaves = [_pool_leaves(c) for c in eng.stage_caches]
    assert [len(x) for x in leaves] == [2, 2]
    arenas = [a for stage in eng._stage_arenas for a in stage]
    assert len({id(a) for a in arenas}) == cfg.n_layers
    assert [id(a) for a in arenas] == [id(a) for a in eng._host_pool]
    flat = [leaf for stage in leaves for leaf in stage]
    gen = torch.Generator().manual_seed(0)
    for leaf in flat:
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    ptrs = [leaf.data_ptr() for leaf in flat]
    before = [leaf.clone() for leaf in flat]
    eng.swap_out_blocks([(3, 0), (4, 1), (7, 4)])
    for leaf in flat:
        leaf[[3, 4, 7]] = -1.0
    eng.swap_in_blocks([(0, 9), (1, 10), (4, 2)])
    keep = [b for b in range(12) if b not in (2, 3, 4, 7, 9, 10)]
    for leaf, old in zip(flat, before):
        assert torch.equal(leaf[[9, 10, 2]], old[[3, 4, 7]])
        assert torch.equal(leaf[keep], old[keep])
    assert [leaf.data_ptr() for leaf in flat] == ptrs


def _pressure_reqs():
    """tests/test_torch_swap.py's two 17-token prompts at 0, 10 new
    tokens each: 7 usable blocks of 8 force an eviction."""
    request_mod._ids = itertools.count()
    return [Request(prompt=np.random.default_rng(i).integers(
                0, SHAPE["vocab_size"], 17).tolist(),
                max_new_tokens=10, arrival_time=0.0) for i in range(2)]


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_pipeline_preemption_matches_pp1(mode):
    """Under pool pressure the offline ``Server(pp=2)`` makes the plans,
    preemptions and greedy tokens of ``pp=1``; those equal the unpressured
    run's tokens."""
    _, _, cfg, params = _models()
    kw = dict(policy="sarathi_serve", chunk_size=8, n_slots=3, max_len=64,
              max_prompt_len=32, token_budget=16, device="cpu")
    tight = dict(paged=True, block_size=8, n_blocks=8)
    if mode == "swap":
        tight.update(host_blocks=16, preempt_mode="swap")
    runs = []
    for pp, extra in ((1, tight), (2, tight), (2, {})):
        srv = serving.Server(cfg, params, pp=pp, **kw, **extra)
        reqs = _pressure_reqs()
        res = srv.run(reqs)
        runs.append(([res.outputs[r.req_id] for r in reqs],
                     [(i.n_prefill_tokens, i.n_decode_tokens)
                      for i in res.iterations],
                     srv.scheduler.n_preemptions))
    assert runs[1] == runs[0]
    assert runs[1][2] > 0
    assert runs[1][0] == runs[2][0]


def test_pipeline_prefix_cache_matches_pp1():
    """``Server(sarathi_serve, prefix_cache=True, pp=2)``: the tokens,
    cached tokens and copy-on-write forks of ``pp=1`` (the shared-prefix
    workload of chip_smoke.py's phase 3, whose repeated prompt forks its
    tail block)."""
    _, _, cfg, params = _models()
    rng = np.random.default_rng(0)
    shared = [rng.integers(0, cfg.vocab_size, 32).tolist()
              for _ in range(2)]
    prompts = [shared[i % 2] + rng.integers(0, cfg.vocab_size, int(n))
               .tolist() for i, n in enumerate((5, 16, 3, 8, 6))]
    prompts.append(list(prompts[1]))
    runs = []
    for pp in (1, 2):
        srv = serving.Server(cfg, params, policy="sarathi_serve",
                             chunk_size=16, n_slots=3, max_len=128,
                             paged=True, block_size=16, prefix_cache=True,
                             pp=pp, device="cpu")
        forks = []
        cow = srv.engine._apply_cow
        srv.engine._apply_cow = lambda pairs: (forks.extend(pairs),
                                               cow(pairs))
        request_mod._ids = itertools.count()
        reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
        res = srv.run(reqs)
        runs.append(([res.outputs[r.req_id] for r in reqs],
                     srv.scheduler.n_cached_tokens, forks))
    assert runs[0] == runs[1]
    assert runs[1][1] > 0 and len(runs[1][2]) >= 1


# --------------------------------------------------------------------------
# (7) what is still unported
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["tp", "sp", "extract_request",
                                  "install_request"])
def test_unported_raise(case):
    _, _, cfg, params = _models()
    if case in ("tp", "sp"):
        kw = dict(tp=2) if case == "tp" else dict(sp=True)
        for cls in (serving.Server, serving.OnlineServer):
            with pytest.raises(NotImplementedError, match="tp/sp"):
                cls(cfg, params, **GEOM, pp=2, device="cpu", **kw)
        return
    eng = PipelineEngine(cfg, params, pp=2, n_slots=2, max_len=64,
                         chunk_size=8, decode_slots=1, device="cpu")
    with pytest.raises(NotImplementedError, match="disagg"):
        if case == "extract_request":
            eng.extract_request(0)
        else:
            eng.install_request(0, None)
