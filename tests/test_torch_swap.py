"""The port's host KV swap tier against the JAX package's, on the CPU: the
engine's round trip (the bytes come back, and the pool is written in place,
which the captured CUDA graphs rely on), greedy tokens and swap counts
under pool pressure equal to the JAX run's and to the port's unpressured
run, the hybrid policy's decision, the ``preempt_mode`` validation, and the
refusal of what is still unported."""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import serving as jserving  # noqa: E402
from repro.cache import BlockManager as JaxBlockManager  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.scheduler import POLICIES as JAX_POLICIES  # noqa: E402
from repro.scheduler import Request as JaxRequest  # noqa: E402
from repro.scheduler import request as jax_request_mod  # noqa: E402
from repro.sim import A100 as JAX_A100  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.cache import BlockManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Engine  # noqa: E402
from repro_torch.scheduler import POLICIES, Request  # noqa: E402
from repro_torch.scheduler import request as request_mod  # noqa: E402
from repro_torch.serving.convert import from_jax_tree  # noqa: E402
from repro_torch.sim import A100  # noqa: E402

# tests/test_swap.py's model and its known-tight geometry: 7 usable blocks
# of 8 admit both 17-token prompts (3 blocks each) but decode growth needs
# an 8th block, so the later request is evicted every run
SHAPE = dict(n_layers=4, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
             d_ff=64, vocab_size=64)
KW = dict(policy="sarathi_serve", chunk_size=8, n_slots=3, max_len=64,
          max_prompt_len=32, token_budget=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast, and keeps the suite's
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models():
    cfg_j = dataclasses.replace(jax_config("tinyllama-1.1b").reduced(),
                                **SHAPE)
    params_j = jax_build_model(cfg_j).init_params(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              **SHAPE)
    return cfg_j, params_j, cfg, from_jax_tree(
        cfg, jax.device_get(params_j), device="cpu")


def _pressure_reqs(request_cls, mod):
    mod._ids = itertools.count()                  # deterministic req ids
    return [request_cls(prompt=np.random.default_rng(i).integers(
                0, SHAPE["vocab_size"], 17).tolist(),
                max_new_tokens=10, arrival_time=0.0) for i in range(2)]


def test_engine_swap_round_trip_in_place():
    """Swap three blocks out, clobber them, swap them in to other blocks:
    the bytes come back, no other block changes, and every pool leaf keeps
    its address (a rebound leaf would leave the graphs on the old pool)."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              **SHAPE)
    from repro_torch.models import init_params
    eng = Engine(cfg, init_params(cfg, seed=0, device="cpu"), n_slots=2,
                 max_len=64, chunk_size=8, decode_slots=1, paged=True,
                 block_size=8, n_blocks=12, host_blocks=6, device="cpu")
    from repro_torch.core.engine import _pool_leaves
    leaves = _pool_leaves(eng.cache)
    assert len(leaves) == cfg.n_layers == len(eng._host_pool)
    assert all(a.shape == (6, *x.shape[1:]) and a.dtype == x.dtype
               for a, x in zip(eng._host_pool, leaves))
    gen = torch.Generator().manual_seed(0)
    for leaf in leaves:
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    ptrs = [leaf.data_ptr() for leaf in leaves]
    before = [leaf.clone() for leaf in leaves]

    eng.swap_out_blocks([(3, 0), (4, 1), (7, 4)])
    for leaf in leaves:
        leaf[[3, 4, 7]] = -1.0
    eng.swap_in_blocks([(0, 9), (1, 10), (4, 2)])
    for leaf, old in zip(leaves, before):
        assert torch.equal(leaf[[9, 10, 2]], old[[3, 4, 7]])
        keep = [b for b in range(12) if b not in (2, 3, 4, 7, 9, 10)]
        assert torch.equal(leaf[keep], old[keep])
    assert [leaf.data_ptr() for leaf in leaves] == ptrs
    eng.swap_out_blocks([])                       # no pairs: no work
    eng.swap_in_blocks([])


def _run(server_cls, request_cls, mod, cfg, params, mode=None, **kw):
    """Greedy tokens (request order), per-iteration composition and swap
    counts of the tight-pool run under ``mode`` (None: unpressured)."""
    if mode is not None:
        kw.update(paged=True, block_size=8, n_blocks=8, host_blocks=16,
                  preempt_mode=mode)
    srv = server_cls(cfg, params, **KW, **kw)
    reqs = _pressure_reqs(request_cls, mod)
    res = srv.run(reqs)
    counts = (getattr(res, "n_swap_outs", None),
              getattr(res, "n_swap_ins", None),
              getattr(res, "n_preemptions", None))
    if mode is not None:
        bm = srv.engine.block_manager
        assert bm.n_used == 0 and bm.n_swapped == 0    # both tiers drained
    return ([res.outputs[r.req_id] for r in reqs],
            [(i.n_prefill_tokens, i.n_decode_tokens)
             for i in res.iterations], counts)


@pytest.mark.parametrize("mode", ["swap", "hybrid"])
def test_swap_under_pressure_matches_jax(mode):
    """tests/test_swap.py's identity grid, port against JAX: the same
    greedy tokens, plans and swap counts as the JAX OnlineServer, and the
    same tokens as the port's unpressured run; the offline Server swaps
    through its hooks to the same tokens."""
    cfg_j, params_j, cfg, params = _models()
    want = _run(jserving.OnlineServer, JaxRequest, jax_request_mod, cfg_j,
                params_j, mode)
    got = _run(serving.OnlineServer, Request, request_mod, cfg, params,
               mode, device="cpu")
    assert got == want
    n_out, n_in, n_preempt = got[2]
    assert n_out > 0 and n_out == n_in and n_preempt > 0
    plain = _run(serving.OnlineServer, Request, request_mod, cfg, params,
                 device="cpu")
    assert got[0] == plain[0]
    offline = _run(serving.Server, Request, request_mod, cfg, params, mode,
                   device="cpu")
    assert offline[0] == plain[0]


@pytest.mark.parametrize("pcie_bw", [1e3, 32e9, 1e18])
def test_hybrid_decision_matches_jax(pcie_bw):
    """The hybrid policy weighs 2 x kv_swap_time against the re-prefill's
    chunked_prefill_total on the same cost model: the same verdict."""
    def decide(policies, bm_cls, req_cls, config, hw):
        cfg = config("tinyllama-1.1b")
        hw = dataclasses.replace(hw, pcie_bw=pcie_bw)
        bm = bm_cls(32, 16, host_blocks=32)
        sched = policies["sarathi_serve"](
            n_slots=4, max_decodes=3, chunk_size=32, block_manager=bm,
            preempt_mode="hybrid", swap_cfg=cfg, swap_hw=hw)
        victim = req_cls(prompt=[1] * 64, max_new_tokens=4)
        victim.prefilled = 64
        bm.ensure(victim.req_id, 64)
        return sched._swap_decision(victim)

    got = decide(POLICIES, BlockManager, Request, get_config, A100)
    assert got == decide(JAX_POLICIES, JaxBlockManager, JaxRequest,
                         jax_config, JAX_A100)
    assert got == (pcie_bw > 1e9)


SCHEDULER_CASES = {
    "bogus_mode": dict(preempt_mode="bogus"),
    "swap_without_pool": dict(preempt_mode="swap"),
    "swap_without_host_tier": dict(preempt_mode="swap", pool=(8, 4, 0)),
    "hybrid_without_cost_model": dict(preempt_mode="hybrid",
                                      pool=(8, 4, 4)),
}
SERVER_CASES = {
    "not_a_swap_policy": dict(policy="sarathi", preempt_mode="swap",
                              paged=True, host_blocks=8),
    "dense_cache": dict(preempt_mode="swap", host_blocks=8),
    "no_host_blocks": dict(preempt_mode="hybrid", paged=True),
}


def _error(fn):
    try:
        fn()
    except (ValueError, KeyError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", sorted(SCHEDULER_CASES)
                         + sorted(SERVER_CASES))
def test_preempt_mode_validation_matches_jax(case):
    """The same arguments raise the same error, with the same message, in
    the port and in the JAX package (tests/test_swap.py's cases, and the
    server builder's)."""
    def scheduler(policies, bm_cls):
        kw = dict(SCHEDULER_CASES[case])
        pool = kw.pop("pool", None)
        if pool:
            kw["block_manager"] = bm_cls(*pool[:2], host_blocks=pool[2])
        return lambda: policies["sarathi_serve"](
            n_slots=2, max_decodes=1, chunk_size=8, **kw)

    def server(srv_mod, cfg, params, **extra):
        kw = dict(dict(policy="sarathi_serve"), **SERVER_CASES[case])
        return lambda: srv_mod.Server(cfg, params, chunk_size=8, n_slots=2,
                                      max_len=64, **kw, **extra)

    if case in SCHEDULER_CASES:
        got = _error(scheduler(POLICIES, BlockManager))
        want = _error(scheduler(JAX_POLICIES, JaxBlockManager))
    else:
        cfg_j, params_j, cfg, params = _models()
        got = _error(server(serving, cfg, params, device="cpu"))
        want = _error(server(jserving, cfg_j, params_j))
    assert got == want
    assert got is not None and got[0] == "ValueError"


@pytest.mark.parametrize("server", ["Server", "OnlineServer"])
def test_pipeline_parallel_refused(server):
    """``tp``, ``sp`` and ``devices`` keep the JAX signature and raise,
    naming their ROADMAP item, also beside ``pp`` (and the online server's
    ``force_pipeline``), which are served (tests/test_torch_pipeline.py)."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              **SHAPE)
    from repro_torch.models import init_params
    params = init_params(cfg, seed=0, device="cpu")
    cls = getattr(serving, server)
    refused = [dict(pp=2, tp=2), dict(tp=2), dict(sp=True),
               dict(devices=["cpu"])]
    if server == "OnlineServer":              # only it takes the argument
        refused.append(dict(force_pipeline=True, sp=True))
    for kw in refused:
        with pytest.raises(NotImplementedError, match="tp/sp"):
            cls(cfg, params, policy="sarathi_serve", chunk_size=8,
                n_slots=2, max_len=64, device="cpu", **kw)
