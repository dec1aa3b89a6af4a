"""The port's batched forward against the JAX package's, and the paper's
three correctness claims held inside the port (tests/test_equivalence.py's
claims, for the dense archs the port has):

1. chunked prefill == full prefill (Fig. 6 'mathematically equivalent'),
2. a decode-maximal hybrid batch == separately computed chunk + decodes
   (§4.3 fused linear operators change nothing numerically),
3. padded final chunks (engine static shapes) change nothing.

Inputs are made with numpy from a seed; weights are the JAX
``init_params(PRNGKey(0))``, carried across by
``repro_torch.serving.convert``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import cached_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, make_packed  # noqa: E402
from repro_torch.serving.convert import from_jax_tree  # noqa: E402

TOL = dict(rtol=5e-4, atol=5e-4)       # tests/test_equivalence.py's tier
ARCHS = ["tinyllama-1.1b", "qwen2-0.5b"]
CHUNKS = [(0, 8), (8, 13), (13, 16)]   # uneven


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast, and keeps the suite's
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(arch):
    """(JAX model, JAX params, port model, port params), same weights."""
    _, jmodel, params_j = cached_model(arch)
    cfg = get_config(arch).reduced()
    params = from_jax_tree(cfg, jax.device_get(params_j), device="cpu")
    return jmodel, params_j, build_model(cfg), params


def _np(t):
    return t.detach().float().numpy()


def _i32(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.int32)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


# --------------------------------------------------------------------------
# forward_batched: port == JAX
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["no_cache", "cached_full", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_batched_matches_jax(arch, mode):
    """The no-cache forward (train=True), the cached full prefill, and
    a prefill in uneven chunks on a cache: every logit at 5e-4."""
    jmodel, params_j, model, params = _port(arch)
    B, L = 2, 16
    toks = _tokens(model.cfg.vocab_size, (B, L), 0)
    if mode == "no_cache":
        want, _, _ = jmodel.forward_batched(params_j, jnp.asarray(toks),
                                            train=True)
        got, _, _ = model.forward_batched(params, _i32(toks), train=True)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        return
    spans = [(0, L)] if mode == "cached_full" else CHUNKS
    jcache = jmodel.init_cache(rows=B, max_len=64)
    tcache = model.init_cache(rows=B, max_len=64, device="cpu")
    for c0, c1 in spans:
        want, jcache, _ = jmodel.forward_batched(
            params_j, jnp.asarray(toks[:, c0:c1]), jcache,
            jnp.full((B,), c0, jnp.int32))
        got, tcache, _ = model.forward_batched(
            params, _i32(toks[:, c0:c1]), tcache, _i32([c0] * B))
        assert got.shape == (B, c1 - c0, model.cfg.vocab_size)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("logits_mode", ["last", "hidden", "none"])
def test_forward_batched_logits_modes_match_jax(logits_mode):
    jmodel, params_j, model, params = _port("qwen2-0.5b")
    toks = _tokens(model.cfg.vocab_size, (2, 11), 1)
    start = np.array([0, 5], np.int32)          # rows at their own offsets
    want, _, _ = jmodel.forward_batched(
        params_j, jnp.asarray(toks), jmodel.init_cache(rows=2, max_len=32),
        jnp.asarray(start), logits_mode=logits_mode)
    got, _, _ = model.forward_batched(
        params, _i32(toks), model.init_cache(rows=2, max_len=32,
                                             device="cpu"),
        _i32(start), logits_mode=logits_mode)
    if logits_mode == "none":
        assert got is None and want is None
    else:
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_forward_batched_refuses_unported_arguments():
    _, _, model, params = _port("tinyllama-1.1b")
    toks = _i32(np.zeros((1, 4)))
    with pytest.raises(NotImplementedError, match="training"):
        model.forward_batched(params, toks, train=True, remat=True)
    with pytest.raises(NotImplementedError, match="other mixers"):
        model.forward_batched(params, toks, memory=torch.zeros((1, 2, 8)))
    with pytest.raises(ValueError, match="logits_mode"):
        model.forward_batched(params, toks, logits_mode="first")
    paged = model.init_cache(rows=1, max_len=16, paged_blocks=3,
                             block_size=8, device="cpu")
    with pytest.raises(ValueError, match="dense cache"):
        model.forward_batched(params, toks, paged, _i32([0]))


# --------------------------------------------------------------------------
# claim 1: chunked prefill == full prefill, in the port
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_train_prefill_chunked_agree(arch):
    """The no-cache forward, the cached full prefill and the uneven
    chunked prefill give the same logits."""
    _, _, model, params = _port(arch)
    B, L = 2, 16
    toks = _i32(_tokens(model.cfg.vocab_size, (B, L), 2))
    logits, _, _ = model.forward_batched(params, toks, train=True)
    assert torch.isfinite(logits).all()

    cache = model.init_cache(rows=B, max_len=64, device="cpu")
    full, cache, _ = model.forward_batched(params, toks, cache,
                                           _i32([0] * B))
    torch.testing.assert_close(logits, full, **TOL)

    cache = model.init_cache(rows=B, max_len=64, device="cpu")
    for c0, c1 in CHUNKS:
        lg, cache, _ = model.forward_batched(params, toks[:, c0:c1], cache,
                                             _i32([c0] * B))
        torch.testing.assert_close(lg, full[:, c0:c1], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_size_invariance(arch):
    """Any chunking of a 17-token prompt yields the same final logits."""
    _, _, model, params = _port(arch)
    P = 17
    toks = _i32(_tokens(model.cfg.vocab_size, (1, P), 3))
    outs = []
    for csize in (P, 5, 3, 1):
        cache = model.init_cache(rows=1, max_len=64, device="cpu")
        s = 0
        while s < P:
            n = min(csize, P - s)
            lg, cache, _ = model.forward_batched(
                params, toks[:, s:s + n], cache, _i32([s]),
                logits_mode="last")
            s += n
        outs.append(lg)
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], **TOL)


# --------------------------------------------------------------------------
# claims 2 and 3: hybrid == separate, padded == unpadded (forward_packed)
# --------------------------------------------------------------------------
BS, M = 8, 4                            # paged: block size, table length
TABLES = {0: [1, 2, 0, 0], 1: [3, 4, 0, 0]}


def _step(paged, chunk=None, decode=None):
    """A packed step: ``chunk`` = (tokens, slot, start, valid rows),
    ``decode`` = (token, slot, ctx); the paged variant adds the block
    tables."""
    kw = {}
    if chunk is not None:
        toks, slot, start, n = chunk
        kw.update(chunk_tokens=toks, chunk_slot=slot, chunk_start=start,
                  chunk_len=n)
        if paged:
            kw["chunk_blocks"] = TABLES[slot]
    if decode is not None:
        tok, slot, ctx = decode
        kw.update(decode_tokens=[tok], decode_slots=[slot], decode_ctx=[ctx])
        if paged:
            kw["decode_blocks"] = [TABLES[slot]]
            kw.setdefault("chunk_blocks", [0] * M)
    return make_packed(device="cpu", **kw)


def _clone(cache):
    """A copy of the in-place cache, so each step reads the same state
    (the JAX caches are values)."""
    return [{n: {k: t.clone() for k, t in leaf.items()}
             for n, leaf in layer.items()} for layer in cache]


def _primed(model, params, paged, tA, tB):
    """Request A prefilled to 8 tokens in slot 0, B to all 12 in slot 1."""
    kw = dict(paged_blocks=6, block_size=BS) if paged else {}
    cache = model.init_cache(rows=2, max_len=M * BS, device="cpu", **kw)
    for chunk in ((list(tA[:8]), 0, 0, 8), (list(tB), 1, 0, 12)):
        _, _, cache, _ = model.forward_packed(params, _step(paged, chunk),
                                              cache)
    return cache


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_maximal_hybrid_equivalence(arch, paged):
    """A's last chunk with B's decode piggybacked gives the logits of the
    chunk-only and decode-only steps."""
    _, _, model, params = _port(arch)
    V = model.cfg.vocab_size
    tA, tB = _tokens(V, 11, 4), _tokens(V, 12, 5)
    cache = _primed(model, params, paged, tA, tB)
    chunk = (list(tA[8:11]), 0, 8, 3)
    decode = (int(tB[-1]), 1, 12)
    cl_ref, _, _, _ = model.forward_packed(params, _step(paged, chunk),
                                           _clone(cache))
    _, dl_ref, _, _ = model.forward_packed(
        params, _step(paged, decode=decode), _clone(cache))
    cl_h, dl_h, _, _ = model.forward_packed(
        params, _step(paged, chunk, decode), _clone(cache))
    torch.testing.assert_close(cl_h, cl_ref, **TOL)
    torch.testing.assert_close(dl_h, dl_ref, **TOL)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_padded_final_chunk_equivalence(arch, paged):
    """A's final chunk padded 3 -> 8 rows (alone, and with B's decode
    piggybacked) gives the unpadded chunk's logits."""
    _, _, model, params = _port(arch)
    V = model.cfg.vocab_size
    tA, tB = _tokens(V, 11, 6), _tokens(V, 12, 7)
    cache = _primed(model, params, paged, tA, tB)
    padded = list(tA[8:11]) + [0] * 5
    decode = (int(tB[-1]), 1, 12)
    cl_ref, _, _, _ = model.forward_packed(
        params, _step(paged, (list(tA[8:11]), 0, 8, 3)), _clone(cache))
    _, dl_ref, _, _ = model.forward_packed(
        params, _step(paged, decode=decode), _clone(cache))
    cl_p, _, _, _ = model.forward_packed(
        params, _step(paged, (padded, 0, 8, 3)), _clone(cache))
    torch.testing.assert_close(cl_p, cl_ref, **TOL)
    cl_h, dl_h, _, _ = model.forward_packed(
        params, _step(paged, (padded, 0, 8, 3), decode), _clone(cache))
    torch.testing.assert_close(cl_h, cl_ref, **TOL)
    torch.testing.assert_close(dl_h, dl_ref, **TOL)
