"""The port's attention kernels on the CPU: their plain PyTorch versions
against the JAX package's Pallas kernels (interpret mode) and its jnp
oracles, the scratch-block and stale-tail contracts, the tiling contract
of the dense entry points, and the launch counts.  The CUDA kernels
themselves run only on the card (``chip_smoke.py`` holds them against
these plain versions there)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import (  # noqa: E402
    paged_chunked_prefill_attention as jax_pcpa,
    paged_decode_attention as jax_pda)
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import launch, ops  # noqa: E402

# fp32: same algorithm, different summation order; bf16: one rounding of
# the PV probabilities and of the output (the JAX suite's own tiers)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
NK, BS = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast, and keeps the suite's
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(x, dtype):
    """The same numbers as a JAX array and a CPU torch tensor."""
    j = jnp.asarray(x, getattr(jnp, dtype))
    t = torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))
    return j, t


def _pool(rng, n_blocks, hd):
    return rng.standard_normal((n_blocks, BS, 2 * NK, hd)).astype(np.float32)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128, 160])
@pytest.mark.parametrize("g", [1, 2, 4, 7])
def test_paged_decode_plain_matches_pallas(g, hd, dtype):
    rng = np.random.default_rng(g * 1000 + hd)
    B, M = 3, 3
    N = B * M + 1
    q = rng.standard_normal((B, g * NK, hd)).astype(np.float32)
    pool = _pool(rng, N, hd)
    bt = rng.permutation(np.arange(1, N))[:B * M].reshape(B, M) \
        .astype(np.int32)
    ctx = np.array([0, 19, M * BS - 1], np.int32)    # first, mid, last
    (qj, qt), (pj, pt) = _pair(q, dtype), _pair(pool, dtype)
    want = jax_pda.paged_decode_attention(qj, pj, bt, ctx, interpret=True)
    got = ops.paged_decode_attention(qt, pt, torch.from_numpy(bt),
                                     torch.from_numpy(ctx))
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128, 160])
@pytest.mark.parametrize("g", [1, 2, 4, 7])
def test_paged_chunked_prefill_plain_matches_pallas(g, hd, dtype):
    rng = np.random.default_rng(g * 1000 + hd + 1)
    C, M, start = 20, 3, 19             # C off any tile; start mid-block
    N = M + 3
    q = rng.standard_normal((C, g * NK, hd)).astype(np.float32)
    pool = _pool(rng, N, hd)
    bt = rng.permutation(np.arange(1, N))[:M].astype(np.int32)
    (qj, qt), (pj, pt) = _pair(q, dtype), _pair(pool, dtype)
    want = jax_pcpa.paged_chunked_prefill_attention(
        qj, pj, bt, start, bq=C, interpret=True)
    got = ops.paged_chunked_prefill_attention(
        qt, pt, torch.from_numpy(bt), torch.tensor(start, dtype=torch.int32))
    _close(got, want, dtype)


def test_paged_chunked_prefill_rows_past_the_table():
    """A padded final chunk whose rows run past the table's M * bs keys:
    those rows see every key (JAX clamps its tail pages), never more."""
    rng = np.random.default_rng(7)
    C, M, start, hd = 16, 3, 40, 64     # rows 40..55 > M * bs - 1 = 47
    q = rng.standard_normal((C, 4 * NK, hd)).astype(np.float32)
    pool = _pool(rng, M + 2, hd)
    bt = np.array([3, 1, 4], np.int32)
    want = jax_pcpa.paged_chunked_prefill_attention(
        jnp.asarray(q), jnp.asarray(pool), bt, start, bq=C, interpret=True)
    got = ops.paged_chunked_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(pool), torch.from_numpy(bt),
        start)
    _close(got, want, "float32")


def test_plain_versions_ignore_poisoned_scratch_tail():
    """Table entries past the allocation name scratch block 0; its
    contents (poisoned here) must never reach the output."""
    rng = np.random.default_rng(3)
    B, M, hd = 2, 4, 64
    N = B * M + 1
    q = torch.from_numpy(rng.standard_normal((B, 4 * NK, hd))
                         .astype(np.float32))
    pool = torch.from_numpy(_pool(rng, N, hd))
    bt = torch.arange(1, 1 + B * M, dtype=torch.int32).reshape(B, M)
    ctx = torch.tensor([20, 40], dtype=torch.int32)
    padded = bt.clone()
    padded[0, 2:] = 0                   # ctx 20 fits in 2 blocks
    poisoned = pool.clone()
    poisoned[0] = 99.0
    full = ops.paged_decode_attention(q, pool, bt, ctx)
    torch.testing.assert_close(
        ops.paged_decode_attention(q, poisoned, padded, ctx), full,
        rtol=1e-6, atol=1e-6)

    qc = torch.from_numpy(rng.standard_normal((10, 4 * NK, hd))
                          .astype(np.float32))
    start = torch.tensor(21, dtype=torch.int32)     # rows 21..30: 2 blocks
    full = ops.paged_chunked_prefill_attention(qc, pool, bt[1], start)
    tbl = bt[1].clone()
    tbl[2:] = 0
    torch.testing.assert_close(
        ops.paged_chunked_prefill_attention(qc, poisoned, tbl, start), full,
        rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# K1 / K2: dense-row kernels, at every shape of tests/test_kernels.py
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,S,nq,nk,hd,start", [
    (128, 256, 4, 4, 64, 0),        # MHA, first chunk
    (128, 512, 8, 2, 64, 128),      # GQA g=4, later chunk
    (256, 1024, 16, 8, 128, 640),   # GQA g=2, deep prefix
    (128, 128, 4, 1, 256, 0),       # MQA, gemma-style head_dim
    (128, 384, 14, 2, 64, 200),     # qwen2 head config (start mid-block)
    (128, 256, 8, 2, 160, 64),      # stablelm head_dim, GQA g=4
])
def test_chunked_prefill_plain_matches_pallas(C, S, nq, nk, hd, start,
                                              dtype):
    rng = np.random.default_rng(C + S + nq)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal(shape).astype(np.float32), dtype)
        for shape in ((C, nq, hd), (S, nk, hd), (S, nk, hd)))
    got = ops.chunked_prefill_attention(qt, kt, vt, start)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, jax_ops.chunked_prefill_attention(qj, kj, vj, start), dtype)
    _close(got, jax_ref.chunked_prefill_attention_ref(qj, kj, vj, start),
           dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,nq,nk,hd", [
    (4, 512, 8, 2, 64),
    (2, 256, 4, 4, 128),
    (3, 384, 16, 1, 64),
    (1, 128, 14, 2, 64),
    (2, 256, 8, 2, 160),            # stablelm head_dim, GQA g=4
])
def test_decode_plain_matches_pallas(B, S, nq, nk, hd, dtype):
    rng = np.random.default_rng(B * S)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal(shape).astype(np.float32), dtype)
        for shape in ((B, nq, hd), (B, S, nk, hd), (B, S, nk, hd)))
    ctx = rng.integers(0, S, B).astype(np.int32)
    got = ops.decode_attention(qt, kt, vt, torch.from_numpy(ctx))
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, jax_ops.decode_attention(qj, kj, vj, jnp.asarray(ctx)), dtype)
    _close(got, jax_ref.decode_attention_ref(qj, kj, vj, jnp.asarray(ctx)),
           dtype)


def test_chunked_prefill_composes_to_full_prefill():
    """The kernel-level Fig. 6 claim: the chunk entry point run chunk by
    chunk reproduces full self-attention (the JAX oracle's)."""
    S, nq, nk, hd, C = 512, 4, 2, 64, 128
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((S, nq, hd), (S, nk, hd), (S, nk, hd)))
    full = jax_ref.chunked_prefill_attention_ref(q, k, v, 0)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    outs = [ops.chunked_prefill_attention(torch.from_numpy(q[s:s + C]), kt,
                                          vt, s) for s in range(0, S, C)]
    _close(torch.cat(outs), full, "float32")


def test_dense_kernels_ignore_stale_tail():
    """Keys past a row's visible ones (stale cache contents, poisoned here
    with +-99) must not reach the output."""
    B, S, nq, nk, hd = 2, 256, 4, 2, 64
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32))
               for shape in ((B, nq, hd), (B, S, nk, hd), (B, S, nk, hd)))
    ctx = torch.tensor([100, 31], dtype=torch.int32)
    k2, v2 = k.clone(), v.clone()
    k2[:, 150:], v2[:, 150:] = 99.0, -99.0
    torch.testing.assert_close(ops.decode_attention(q, k2, v2, ctx),
                               ops.decode_attention(q, k, v, ctx),
                               rtol=1e-6, atol=1e-6)

    C, start = 128, 20                   # rows see keys <= 147
    qc = torch.from_numpy(rng.standard_normal((C, nq, hd))
                          .astype(np.float32))
    torch.testing.assert_close(
        ops.chunked_prefill_attention(qc, k2[0], v2[0], start),
        ops.chunked_prefill_attention(qc, k[0], v[0], start),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("C,S,bq,bk", [(100, 256, 128, 128),
                                       (128, 200, 128, 128),
                                       (128, 256, 64, 96)])
def test_chunked_prefill_untiled_shapes_raise_as_jax(C, S, bq, bk):
    q = np.zeros((C, 4, 64), np.float32)
    k = np.zeros((S, 2, 64), np.float32)
    with pytest.raises(ValueError) as want:
        jax_ops.chunked_prefill_attention(q, k, k, 0, bq=bq, bk=bk)
    with pytest.raises(ValueError) as got:
        ops.chunked_prefill_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(k), 0, bq=bq, bk=bk)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("S,bk", [(200, 128), (256, 96)])
def test_decode_untiled_shapes_raise_as_jax(S, bk):
    q = np.zeros((2, 4, 64), np.float32)
    k = np.zeros((2, S, 2, 64), np.float32)
    ctx = np.array([3, 9], np.int32)
    with pytest.raises(ValueError) as want:
        jax_ops.decode_attention(q, k, k, ctx, bk=bk)
    with pytest.raises(ValueError) as got:
        ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(k), torch.from_numpy(ctx),
                             bk=bk)
    assert str(got.value) == str(want.value)


def test_cpu_calls_launch_no_kernel():
    ops.reset_launches()
    rng = np.random.default_rng(0)
    pool = torch.from_numpy(_pool(rng, 3, 64))
    q = torch.zeros((2, 2 * NK, 64))
    ops.paged_decode_attention(q, pool, torch.ones((2, 2), dtype=torch.int32),
                               torch.tensor([3, 17], dtype=torch.int32))
    ops.paged_chunked_prefill_attention(
        q, pool, torch.tensor([1, 2], dtype=torch.int32), 5)
    k = torch.zeros((2, 128, NK, 64))
    ops.decode_attention(q, k, k, torch.tensor([3, 17], dtype=torch.int32))
    ops.chunked_prefill_attention(torch.zeros((128, 2 * NK, 64)), k[0],
                                  k[0], 0)
    assert ops.launches == {"paged_chunked_prefill_attention": 0,
                            "paged_decode_attention": 0,
                            "chunked_prefill_attention": 0,
                            "decode_attention": 0}


def test_non_cpu_tensor_without_kernel_raises():
    """A tensor that is neither on the CPU nor on a CUDA device has no
    kernel and no fallback."""
    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    q = meta(2, 4, 64)
    with pytest.raises(ValueError):
        ops.paged_decode_attention(q, meta(3, BS, 4, 64),
                                   meta(2, 2, dtype=torch.int32),
                                   meta(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.decode_attention(q, meta(2, 128, 2, 64), meta(2, 128, 2, 64),
                             meta(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.chunked_prefill_attention(meta(128, 4, 64), meta(128, 2, 64),
                                      meta(128, 2, 64), 0)
    assert set(ops.launches.values()) == {0}


# --------------------------------------------------------------------------
# what the CUDA wrappers take, and the decode kernels' split
# --------------------------------------------------------------------------
def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("name", sorted(launch.KERNELS))
def test_check_inputs_takes_head_dim_160(name):
    """Every kernel is built for head dim 160 (stablelm-12b): the checks
    pass the head dim and stop only at the device (no card here)."""
    assert 160 in launch.KERNELS[name][0]
    with pytest.raises(ValueError, match="q on meta"):
        launch.check_inputs(name, _meta(3, 32, 160), 8, kv={}, ints={})


@pytest.mark.parametrize("name", sorted(launch.KERNELS))
@pytest.mark.parametrize("hd", [96, 192])
def test_check_inputs_rejects_unbuilt_head_dim(name, hd):
    with pytest.raises(ValueError, match=f"head_dim {hd} not in"):
        launch.check_inputs(name, _meta(3, 32, hd), 8, kv={}, ints={})


@pytest.mark.parametrize("capacity", [1, 127, 129, 2048, 32768])
@pytest.mark.parametrize("n_blocks", [1, 56, 280, 10_000])
def test_decode_split_covers_every_key(capacity, n_blocks, sms=132):
    n_split, split_len = launch.decode_split(capacity, n_blocks, sms)
    assert n_split >= 1 and split_len >= 1
    assert n_split * split_len >= capacity              # every key
    assert (n_split - 1) * split_len < capacity         # none empty
    assert split_len % launch.SPLIT_QUANTUM == 0        # whole tiles
    if n_blocks >= launch.WAVES * launch.RESIDENT * sms:
        assert n_split == 1                             # enough blocks


def test_decode_workspace_reads_no_tensor():
    """The split comes from shapes alone: on meta tensors (which hold no
    values to read) it plans the call and sizes the fp32 workspace."""
    q = _meta(7, 40, 128)
    n_split, split_len, ws = launch.decode_workspace(q, 40, 2048, sms=132)
    assert (n_split, split_len) == launch.decode_split(2048, 7 * 40, 132)
    assert n_split > 1
    assert ws.device.type == "meta" and ws.dtype == torch.float32
    assert ws.numel() == 7 * 40 * n_split * (128 + 2)
    _, _, ws = launch.decode_workspace(_meta(7, 40, 128), 40, 128, sms=132)
    assert ws.numel() == 0                              # one split: none
