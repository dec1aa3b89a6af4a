"""The port's model primitives and its hybrid packed step, against the JAX
package on the CPU, from the same inputs (made with numpy from a seed) and
the same weights (the JAX ``init_params(PRNGKey(0))``, carried across by
``repro_torch.serving.convert``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import cached_model  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import make_packed as jax_make_packed  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, make_packed  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.serving.convert import (  # noqa: E402
    from_jax_tree, to_jax_tree)

TOL = dict(rtol=5e-4, atol=5e-4)       # tests/test_equivalence.py's tier


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast, and keeps the suite's
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().float().numpy()


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    want = jcm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = cm.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    pos = np.array([0, 1, 7, 300, 2047], np.int32)
    x = rng.standard_normal((5, 4, 64)).astype(np.float32)
    js, jc = jcm.rope_sin_cos(jnp.asarray(pos), 64, theta)
    ts, tc = cm.rope_sin_cos(torch.from_numpy(pos), 64, theta)
    np.testing.assert_allclose(_np(ts), np.asarray(js), **TOL)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), **TOL)
    want = jcm.apply_rope(jnp.asarray(x), js, jc)
    got = cm.apply_rope(torch.from_numpy(x), ts, tc)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_interleave_split_round_trip_matches_jax():
    rng = np.random.default_rng(2)
    k = rng.standard_normal((3, 5, 2, 8)).astype(np.float32)
    v = rng.standard_normal((3, 5, 2, 8)).astype(np.float32)
    fused = cm.interleave_kv(torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_array_equal(
        fused.numpy(), np.asarray(jcm.interleave_kv(k, v)))
    k2, v2 = cm.split_fused_kv(fused)
    np.testing.assert_array_equal(k2.numpy(), k)
    np.testing.assert_array_equal(v2.numpy(), v)


@pytest.mark.parametrize("start", [0, 5, 12, 16])
def test_write_kv_slot_drops_rows_past_the_cache(start):
    """A chunk whose padded width spills past max_len writes its in-range
    rows and drops the rest — never clamps onto live positions."""
    rng = np.random.default_rng(3)
    cache = rng.standard_normal((2, 16, 2, 4)).astype(np.float32)
    new = rng.standard_normal((8, 2, 4)).astype(np.float32)
    want = jcm.write_kv_slot(jnp.asarray(cache), jnp.asarray(new), 1, start)
    got = cm.write_kv_slot(torch.from_numpy(cache.copy()),
                           torch.from_numpy(new), 1, start)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-0.5b"])
def test_convert_round_trip(arch):
    cfg_j, _, params_j = cached_model(arch)
    tree = jax.device_get(params_j)
    model = from_jax_tree(get_config(arch).reduced(), tree, device="cpu")
    back = to_jax_tree(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    names = {n for n, _ in model.named_parameters()}
    assert "layers.0.mixer.wq" in names and "layers.1.ffn.w_down" in names
    assert ("layers.0.mixer.bq" in names) == cfg_j.qkv_bias
    assert ("unembed" in names) == (not cfg_j.tie_embeddings)


def _steps(rng, vocab):
    """Three packed steps on two requests, two decode lanes: chunk A[0:8]
    alone; chunk B[0:8] with A's first decode piggybacked; B's padded final
    chunk B[8:13] (5 valid rows of 8) with A's next decode.  The second
    lane is always unused."""
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
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-0.5b"])
def test_hybrid_forward_packed_matches_jax(arch, paged):
    """Chunk + piggybacked decodes in one packed step: chunk logits and
    the real decode lanes' logits agree with JAX at 5e-4, dense and paged
    (the unused lane writes the shared scratch row/block, whose winner
    among duplicate writes is unspecified, so it is not compared)."""
    cfg_j, jmodel, params_j = cached_model(arch)
    cfg = get_config(arch).reduced()
    params = from_jax_tree(cfg, jax.device_get(params_j), device="cpu")
    model = build_model(cfg)
    kw = dict(paged_blocks=6, block_size=8) if paged else {}
    jcache = jmodel.init_cache(3, 32, **kw)
    tcache = model.init_cache(3, 32, device="cpu", **kw)
    rng = np.random.default_rng(4)
    for i, step in enumerate(_steps(rng, cfg.vocab_size)):
        if not paged:
            step = dict(step, chunk_blocks=[], decode_blocks=[[], []])
        jc, jd, jcache, _ = jmodel.forward_packed(
            params_j, jax_make_packed(**step), jcache)
        with torch.inference_mode():
            tc, td, tcache, _ = model.forward_packed(
                params, make_packed(**step), tcache)
        np.testing.assert_allclose(_np(tc), np.asarray(jc), **TOL)
        n_real = 0 if i == 0 else 1
        np.testing.assert_allclose(_np(td[:n_real]),
                                   np.asarray(jd[:n_real]), **TOL)
