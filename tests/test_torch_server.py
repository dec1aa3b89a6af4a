"""The port's offline Server against the JAX package's, on the CPU: the
quickstart workload (``examples/quickstart.py``) under each ported policy
must give the same per-iteration composition and the same greedy tokens,
from the same weights.  Inside the port, the paged pool must replay the
dense cache exactly, and the engine's static step inputs must carry
nothing of one step into the next."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from conftest import cached_model  # noqa: E402
from repro.core import ChunkWork as JaxChunkWork  # noqa: E402
from repro.core import DecodeWork as JaxDecodeWork  # noqa: E402
from repro.core import Engine as JaxEngine  # noqa: E402
from repro.core import IterationPlan as JaxIterationPlan  # noqa: E402
from repro.scheduler import Request as JaxRequest  # noqa: E402
from repro.serving import Server as JaxServer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ChunkWork, DecodeWork, Engine,  # noqa: E402
                              IterationPlan, SamplingParams,
                              quantized_chunk_size)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.scheduler import Request  # noqa: E402
from repro_torch.serving import Server  # noqa: E402
from repro_torch.serving.convert import from_jax_tree  # noqa: E402

N_SLOTS = 4
CHUNK = quantized_chunk_size(target=16, n_decodes=N_SLOTS - 1, tile=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast, and keeps the suite's
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _workload(request_cls, vocab):
    rng = np.random.default_rng(0)
    return [request_cls(prompt=rng.integers(0, vocab, int(n)).tolist(),
                        max_new_tokens=8) for n in (37, 21, 44, 9)]


def _serve(server_cls, request_cls, cfg, params, **kw):
    reqs = _workload(request_cls, cfg.vocab_size)
    res = server_cls(cfg, params, chunk_size=CHUNK, n_slots=N_SLOTS,
                     max_len=256, **kw).run(reqs)
    comp = [(s.n_prefill_tokens, s.n_decode_tokens) for s in res.iterations]
    return comp, [res.outputs[r.req_id] for r in reqs]


def _jax_and_port_models():
    cfg_j, _, params_j = cached_model("tinyllama-1.1b")
    cfg = get_config("tinyllama-1.1b").reduced()
    params = from_jax_tree(cfg, jax.device_get(params_j), device="cpu")
    return cfg_j, params_j, cfg, params


@pytest.mark.parametrize("policy", ["sarathi", "orca", "request_level",
                                    "sarathi_serve"])
def test_server_matches_jax(policy):
    cfg_j, params_j, cfg, params = _jax_and_port_models()
    want = _serve(JaxServer, JaxRequest, cfg_j, params_j, policy=policy)
    dense = _serve(Server, Request, cfg, params, policy=policy,
                   device="cpu")
    paged = _serve(Server, Request, cfg, params, policy=policy,
                   device="cpu", paged=True, block_size=16)
    assert dense == want
    assert paged == dense


@pytest.mark.parametrize("token_budget", [CHUNK // 2, 2 * CHUNK + 3])
def test_token_budget_matches_jax(token_budget):
    """sarathi_serve under a token budget below the chunk (chunks shrink)
    and above it (multi-chunk plans run as consecutive sub-steps): the
    same composition and greedy tokens as the JAX Server, dense and
    paged."""
    cfg_j, params_j, cfg, params = _jax_and_port_models()
    kw = dict(policy="sarathi_serve", token_budget=token_budget)
    want = _serve(JaxServer, JaxRequest, cfg_j, params_j, **kw)
    dense = _serve(Server, Request, cfg, params, device="cpu", **kw)
    paged = _serve(Server, Request, cfg, params, device="cpu", paged=True,
                   block_size=16, **kw)
    assert dense == want
    assert paged == dense
    if token_budget > CHUNK:
        assert max(n for n, _ in want[0]) > CHUNK      # multi-chunk plans


@pytest.mark.parametrize("paged", [False, True])
def test_static_step_inputs_leak_nothing_between_steps(paged):
    """Plans that shrink from 3 decode lanes to 1, then end a prompt with
    a shorter final chunk, then decode the requests whose lanes went
    unused: the port engine's static step inputs must give the JAX
    engine's tokens on the same plans, so no field of an earlier step (a
    stale lane, table entry or chunk token, which would write into a live
    block) survives."""
    cfg_j, params_j, cfg, params = _jax_and_port_models()
    rng = np.random.default_rng(5)
    a, b, c = (rng.integers(0, cfg.vocab_size, 8).tolist() for _ in "abc")
    d = rng.integers(0, cfg.vocab_size, 13).tolist()
    kw = dict(n_slots=4, max_len=64, chunk_size=8, decode_slots=3,
              paged=paged, block_size=8)
    engines = [(JaxEngine(cfg_j, params_j, **kw), JaxChunkWork,
                JaxDecodeWork, JaxIterationPlan),
               (Engine(cfg, params, device="cpu", **kw), ChunkWork,
                DecodeWork, IterationPlan)]
    for eng, *_ in engines:
        for rid in range(4):
            eng.add_request(rid)
    last = {}                       # req -> (last token, ctx), from JAX

    def plans(cw, dw, ip):
        def dec(*rids):
            return [dw(r, *last[r]) for r in rids]
        return [lambda: ip(chunk=cw(0, a, 0, True)),
                lambda: ip(chunk=cw(1, b, 0, True), decodes=dec(0)),
                lambda: ip(chunk=cw(2, c, 0, True), decodes=dec(0, 1)),
                lambda: ip(chunk=cw(3, d[:8], 0, False),
                           decodes=dec(0, 1, 2)),
                lambda: ip(decodes=dec(0)),
                lambda: ip(chunk=cw(3, d[8:], 8, True), decodes=dec(0)),
                lambda: ip(decodes=dec(1, 2, 3))]

    steps = zip(*(plans(*e[1:]) for e in engines))
    for step, (jax_plan, port_plan) in enumerate(steps):
        want = engines[0][0].execute(jax_plan())
        got = engines[1][0].execute(port_plan())
        assert got == want, f"step {step}"
        for rid, tok in want.items():
            ctx = last[rid][1] + 1 if rid in last else \
                (len(d) if rid == 3 else 8)
            last[rid] = (tok, ctx)


def test_paged_engine_replays_dense_exactly():
    """Port paged == port dense bit for bit, through chunks, a padded final
    chunk and decodes, for qwen2 (qkv bias, tied embeddings)."""
    cfg = get_config("qwen2-0.5b").reduced()
    params = init_params(cfg, seed=3, device="cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 19).tolist()

    def generate(eng):
        eng.add_request(0)
        out = []
        for s in range(0, len(prompt), 8):
            r = eng.execute(IterationPlan(chunk=ChunkWork(
                0, prompt[s:s + 8], s, s + 8 >= len(prompt))))
        out.append(r[0])
        while len(out) < 6:
            r = eng.execute(IterationPlan(decodes=[
                DecodeWork(0, out[-1], len(prompt) + len(out) - 1)]))
            out.append(r[0])
        eng.release(0)
        return out

    kw = dict(n_slots=2, max_len=64, chunk_size=8, decode_slots=2,
              device="cpu")
    want = generate(Engine(cfg, params, **kw))
    paged = Engine(cfg, params, paged=True, block_size=16, **kw)
    assert generate(paged) == want
    assert paged.block_manager.n_used == 0        # freed on release


def test_warmup_consumes_no_state():
    cfg = get_config("tinyllama-1.1b").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    sampling = SamplingParams(temperature=1.0, top_k=20)
    outs = []
    for warm in (False, True):
        srv = Server(cfg, params, chunk_size=CHUNK, n_slots=N_SLOTS,
                     max_len=256, paged=True, sampling=sampling, seed=7,
                     device="cpu")
        if warm:
            srv.engine.warmup()
        reqs = _workload(Request, cfg.vocab_size)
        res = srv.run(reqs)
        outs.append([res.outputs[r.req_id] for r in reqs])
    assert outs[0] == outs[1]          # stochastic, yet reproducible


@pytest.mark.parametrize("kw", [
    dict(tp=2), dict(pp=2, tp=2), dict(sp=True), dict(devices=["cpu"]),
    dict(policy="sarathi_serve", tp=2, host_blocks=8, preempt_mode="swap"),
    dict(policy="sarathi_serve", pp=2, sp=True, preempt_mode="hybrid"),
])
def test_unported_arguments_raise(kw):
    cfg = get_config("tinyllama-1.1b").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Server(cfg, params, chunk_size=CHUNK, n_slots=N_SLOTS, max_len=256,
               paged=True, device="cpu", **kw)


def test_unported_layer_kinds_raise():
    from repro_torch.configs.base import ModelConfig
    cfg = ModelConfig(name="moe", family="moe", n_layers=1, d_model=16,
                      n_heads=2, n_kv_heads=1, d_ff=32, vocab_size=64,
                      n_experts=2, top_k=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_params(cfg, device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
