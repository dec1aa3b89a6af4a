"""The port's online serving against the JAX package's, on the CPU: the
arrival-driven loop on the cost-model clock (every record, token time and
summary equal), the workload generators (equal arrays and prompts), the
metrics table (the same string), and the port's ``OnlineServer`` on the
reduced tinyllama with arrivals all at 0 (the same per-iteration
composition and greedy tokens as the JAX ``OnlineServer``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from conftest import cached_model  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.cache import BlockManager as JaxBlockManager  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.scheduler import POLICIES as JAX_POLICIES  # noqa: E402
from repro.scheduler import Request as JaxRequest  # noqa: E402
from repro.sim import A100 as JAX_A100  # noqa: E402
from repro_torch import data, serving  # noqa: E402
from repro_torch.cache import BlockManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.scheduler import POLICIES, Request  # noqa: E402
from repro_torch.serving.convert import from_jax_tree  # noqa: E402
from repro_torch.sim import A100  # noqa: E402

PORT = (serving, POLICIES, BlockManager, get_config, A100)
JAX = (jserving, JAX_POLICIES, JaxBlockManager, jax_config, JAX_A100)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast, and keeps the suite's
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# arrival process -> online_workload kwargs; "bursty" also runs a tight
# pool with a host tier under preempt_mode="hybrid", so that the loop's
# preemption and swap hooks (and the cost model's swap charge) take part
ARRIVALS = {
    "poisson": dict(arrival="poisson", rate=4.0),
    "bursty": dict(arrival="bursty", rate=8.0, burst=4),
    "uniform": dict(arrival="uniform", rate=2.0),
    "trace": dict(trace=[0.0, 0.0, 0.05, 0.3, 0.3, 0.31, 0.9, 1.4, 1.4,
                         2.0, 2.5, 2.55]),
}


def _cost_model_run(impl, arrival):
    """``serve_online`` on the cost-model clock (paper-llama-13b on the
    A100 profile) under sarathi_serve; returns the run in plain tuples,
    requests in workload order, and the summary."""
    srv, policies, bm_cls, config, hw = impl
    cfg = config("paper-llama-13b")
    reqs = srv.online_workload(12, pd_ratio=8.0, min_len=64, max_len=600,
                               vocab_size=cfg.vocab_size, seed=3,
                               **ARRIVALS[arrival])
    kw = dict(n_slots=4, max_decodes=3, chunk_size=128, token_budget=160)
    if arrival == "bursty":
        kw.update(block_manager=bm_cls(40, 16, host_blocks=64),
                  preempt_mode="hybrid", swap_cfg=cfg, swap_hw=hw)
    res = srv.serve_online(policies["sarathi_serve"](**kw),
                           srv.CostModelExecutor(cfg, hw), reqs)
    summary = res.summary()
    traces = [dataclasses.astuple(res.traces[r.req_id])[1:] for r in reqs]
    run = ([dataclasses.astuple(i) for i in res.iterations], traces,
           [res.outputs[r.req_id] for r in reqs], res.makespan,
           res.n_preemptions, res.n_swap_outs, res.n_swap_ins,
           res.kv_swap_time, res.peak_pool_util, res.peak_resident,
           repr(dataclasses.astuple(summary)), summary.throughput)
    return run, summary


@pytest.mark.parametrize("arrival", sorted(ARRIVALS))
def test_cost_model_serving_equals_jax(arrival):
    got, summary = _cost_model_run(PORT, arrival)
    want, _ = _cost_model_run(JAX, arrival)
    assert got == want
    assert summary.n_requests == 12 and summary.ttft.n == 12
    if arrival == "bursty":
        assert got[5] > 0 and got[5] == got[6]     # swapped and resumed


WORKLOADS = {
    "poisson_arrivals": lambda m: m.poisson_arrivals(20, 3.0, seed=5),
    "bursty_arrivals": lambda m: m.bursty_arrivals(19, 3.0, burst=4,
                                                   seed=5),
    "uniform_arrivals": lambda m: m.uniform_arrivals(9, 4.0),
    "trace_arrivals": lambda m: m.trace_arrivals([0.0, 0.5, 0.5, 2.0]),
    "online_workload": lambda m: m.online_workload(
        10, rate=2.0, pd_ratio=8.0, min_len=1024, max_len=2048, theta=0.4,
        vocab_size=32000, seed=0),
    "shared_prefix_workload": lambda m: m.shared_prefix_workload(
        7, shared_len=40, unique_len=9, n_decode=5, n_groups=2, rate=3.0,
        seed=4),
    "multiturn_workload": lambda m: m.multiturn_workload(
        3, 4, turn_len=11, n_decode=3, turn_gap=0.5, rate=1.0, seed=2),
}


def _plain(x):
    """Arrays and requests as comparable plain values."""
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.tolist())
    return [(r.prompt, r.max_new_tokens, r.arrival_time, r.eos_token)
            for r in x]


@pytest.mark.parametrize("name", sorted(WORKLOADS) + ["serving_workload",
                                                      "zipf_lengths"])
def test_workloads_equal_jax(name):
    if name == "serving_workload":
        got, want = (m.serving_workload(9, pd_ratio=4.0, min_len=32,
                                        max_len=300, seed=6, vocab_size=500)
                     for m in (data, jdata))
    elif name == "zipf_lengths":
        got, want = (_plain(m.zipf_lengths(50, lo=1024, hi=4096, seed=1))
                     for m in (data, jdata))
    else:
        got, want = (_plain(WORKLOADS[name](m)) for m in (serving, jserving))
    assert got == want
    assert len(got) > 1


@pytest.mark.parametrize("unit", ["s", "ms", "us"])
def test_format_table_equals_jax(unit):
    _, got = _cost_model_run(PORT, "bursty")
    _, want = _cost_model_run(JAX, "bursty")
    text = serving.format_table(got, unit=unit)
    assert text == jserving.format_table(want, unit=unit)
    assert "swap_outs=" in text and f"[{unit}]" in text


# the reduced tinyllama: test_online.py's replay of the offline server
# (one chunk a plan, no backoff) and the default budget path on the pool
SERVERS = {
    "replay": dict(token_budget=8 + 2, policy_kwargs=dict(
        max_chunks_per_iter=1, admit_backoff=False)),
    "budget_paged": dict(token_budget=20, paged=True, block_size=16),
}


def _online(server_cls, request_cls, cfg, params, case, **kw):
    rng = np.random.default_rng(1)
    reqs = [request_cls(prompt=rng.integers(0, cfg.vocab_size, int(n))
                        .tolist(), max_new_tokens=6, arrival_time=0.0)
            for n in (13, 9, 21, 5, 17)]
    res = server_cls(cfg, params, policy="sarathi_serve", chunk_size=8,
                     n_slots=3, max_len=256, max_prompt_len=32,
                     **SERVERS[case], **kw).run(reqs)
    comp = [(i.n_prefill_tokens, i.n_decode_tokens) for i in res.iterations]
    return comp, [res.outputs[r.req_id] for r in reqs]


@pytest.mark.parametrize("case", sorted(SERVERS))
def test_online_server_matches_jax(case):
    cfg_j, _, params_j = cached_model("tinyllama-1.1b")
    cfg = get_config("tinyllama-1.1b").reduced()
    params = from_jax_tree(cfg, jax.device_get(params_j), device="cpu")
    want = _online(jserving.OnlineServer, JaxRequest, cfg_j, params_j, case)
    got = _online(serving.OnlineServer, Request, cfg, params, case,
                  device="cpu")
    assert got == want
    assert all(len(out) == 6 for out in got[1])


def test_executors_refuse_disagg():
    """The executors keep the JAX methods of phase-disaggregated serving,
    which the port has not got yet: they raise, naming the item."""
    from repro_torch.core import Engine
    from repro_torch.models import init_params
    cfg = get_config("tinyllama-1.1b").reduced()
    eng = Engine(cfg, init_params(cfg, seed=0, device="cpu"), n_slots=2,
                 max_len=64, chunk_size=8, decode_slots=1, device="cpu")
    req = Request(prompt=[1, 2, 3], max_new_tokens=2)
    for ex in (serving.EngineExecutor(eng),
               serving.CostModelExecutor(cfg, A100)):
        with pytest.raises(NotImplementedError, match="disagg"):
            ex.extract(req)
        with pytest.raises(NotImplementedError, match="disagg"):
            ex.install(req, None)
