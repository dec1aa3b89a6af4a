"""The port's offline Server against the JAX package's, on the CPU: the
quickstart workload (``examples/quickstart.py``) under each ported policy
must give the same per-iteration composition and the same greedy tokens,
from the same weights.  Inside the port, the paged pool must replay the
dense cache exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from conftest import cached_model  # noqa: E402
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


@pytest.mark.parametrize("policy", ["sarathi", "orca", "request_level"])
def test_server_matches_jax(policy):
    cfg_j, _, params_j = cached_model("tinyllama-1.1b")
    cfg = get_config("tinyllama-1.1b").reduced()
    params = from_jax_tree(cfg, jax.device_get(params_j), device="cpu")
    want = _serve(JaxServer, JaxRequest, cfg_j, params_j, policy=policy)
    dense = _serve(Server, Request, cfg, params, policy=policy,
                   device="cpu")
    paged = _serve(Server, Request, cfg, params, policy=policy,
                   device="cpu", paged=True, block_size=16)
    assert dense == want
    assert paged == dense


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
    dict(tp=2), dict(pp=2), dict(sp=True), dict(prefix_cache=True),
    dict(host_blocks=8), dict(preempt_mode="swap"), dict(token_budget=64),
    dict(policy="sarathi_serve"),
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
