"""The port's copy-on-write prefix cache against the JAX package's, on
the CPU: ``Server(policy="sarathi_serve", paged=True, prefix_cache=True)``
must give the JAX Server's composition, greedy tokens and cached-token
count, and the cache must change no token.  The admission gate of the
port's copy is fixed where the JAX package's over-counts free blocks
(ROADMAP Queue 3): the falsifying example raises in the JAX package and
not in the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

import jax  # noqa: E402
from hypothesis import example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from conftest import cached_model  # noqa: E402
from repro.cache import BlockManager as JaxBlockManager  # noqa: E402
from repro.cache import PoolExhausted as JaxPoolExhausted  # noqa: E402
from repro.cache import PrefixCache as JaxPrefixCache  # noqa: E402
from repro.scheduler import Request as JaxRequest  # noqa: E402
from repro.serving import Server as JaxServer  # noqa: E402
from repro_torch.cache import BlockManager, PrefixCache  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.scheduler import Request  # noqa: E402
from repro_torch.serving import Server  # noqa: E402
from repro_torch.serving.convert import from_jax_tree  # noqa: E402

# falsifying examples of the JAX package's
# test_refcount_conservation_under_random_lifecycle (ROADMAP Queue 3)
ADMISSION_EXAMPLE = dict(n_blocks=4, block_size=6, script=[8268, 2, 108, 8268])
ADMISSION_EXAMPLE_2 = dict(n_blocks=4, block_size=1, script=[684, 2, 8556, 0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models():
    cfg_j, _, params_j = cached_model("tinyllama-1.1b")
    cfg = get_config("tinyllama-1.1b").reduced()
    params = from_jax_tree(cfg, jax.device_get(params_j), device="cpu")
    return cfg_j, params_j, cfg, params


def _shared_prefix(request_cls, vocab):
    """Six requests on two 24-token prefixes (three blocks of 8) with 3-11
    unique tokens each; the sixth repeats the second's prompt."""
    rng = np.random.default_rng(0)
    shared = [rng.integers(0, vocab, 24).tolist() for _ in range(2)]
    prompts = [shared[i % 2] + rng.integers(0, vocab, int(n)).tolist()
               for i, n in enumerate((5, 11, 3, 8, 6))]
    prompts.append(list(prompts[1]))
    return [request_cls(prompt=p, max_new_tokens=6, req_id=i)
            for i, p in enumerate(prompts)]


def _serve(server_cls, request_cls, cfg, params, reqs_fn=_shared_prefix,
           n_slots=3, **kw):
    """Serve the workload; returns (composition, tokens, cached tokens,
    server)."""
    reqs = reqs_fn(request_cls, cfg.vocab_size)
    srv = server_cls(cfg, params, policy="sarathi_serve", chunk_size=16,
                     n_slots=n_slots, max_len=128, paged=True, block_size=8,
                     **kw)
    res = srv.run(reqs)
    comp = [(s.n_prefill_tokens, s.n_decode_tokens) for s in res.iterations]
    return (comp, [res.outputs[r.req_id] for r in reqs],
            srv.scheduler.n_cached_tokens, srv)


def _cow_counter(srv):
    """Count the copy-on-write pairs the port engine copies."""
    pairs = []
    apply = srv.engine._apply_cow

    def counted(p):
        pairs.extend(p)
        apply(p)

    srv.engine._apply_cow = counted
    return pairs


def test_prefix_cache_server_matches_jax():
    """More requests than slots on shared prefixes: the JAX Server's
    composition, greedy tokens and cached-token count."""
    cfg_j, params_j, cfg, params = _models()
    want = _serve(JaxServer, JaxRequest, cfg_j, params_j, prefix_cache=True)
    got = _serve(Server, Request, cfg, params, prefix_cache=True,
                 device="cpu")
    assert got[:3] == want[:3]
    assert got[2] > 0                              # the cache was used


def test_prefix_cache_on_equals_off():
    """Inside the port the cache changes no token, only what is
    prefilled."""
    _, _, cfg, params = _models()
    on = _serve(Server, Request, cfg, params, prefix_cache=True,
                device="cpu")
    off = _serve(Server, Request, cfg, params, device="cpu")
    assert on[1] == off[1]
    assert on[2] > 0 and off[2] == 0
    assert sum(n for n, _ in on[0]) == sum(n for n, _ in off[0]) - on[2]


def _identical(request_cls, vocab):
    prompt = np.random.default_rng(11).integers(0, vocab, 16).tolist()
    return [request_cls(prompt=list(prompt), max_new_tokens=4, req_id=i)
            for i in range(2)]


def test_identical_prompt_trimmed_hit_matches_jax():
    """One slot: the second copy of a prompt is admitted after the first
    finished, takes the trimmed full-prompt hit (all but one token), and
    forks the shared tail block copy-on-write; its tokens equal JAX's and
    the first copy's."""
    cfg_j, params_j, cfg, params = _models()
    kw = dict(reqs_fn=_identical, n_slots=1, prefix_cache=True)
    want = _serve(JaxServer, JaxRequest, cfg_j, params_j, **kw)
    reqs = _identical(Request, cfg.vocab_size)
    srv = Server(cfg, params, policy="sarathi_serve", chunk_size=16,
                 n_slots=1, max_len=128, paged=True, block_size=8,
                 prefix_cache=True, device="cpu")
    pairs = _cow_counter(srv)
    res = srv.run(reqs)
    got = [res.outputs[r.req_id] for r in reqs]
    assert got == want[1]
    assert got[0] == got[1]
    assert reqs[1].cached_tokens == len(reqs[1].prompt) - 1 == want[2]
    assert len(pairs) == 1                         # the tail block forked
    bm = srv.engine.block_manager
    assert bm.n_free + bm.n_referenced == bm.n_usable


def _lifecycle(block_manager, prefix_cache, n_blocks, block_size, script,
               hit_aware):
    """The JAX package's random admit(match+share)/commit/free/evict
    lifecycle (tests/test_prefix_cache.py), with the admission gate given
    the hit blocks (the port's fix) or not (the JAX gate)."""
    bm = block_manager(n_blocks, block_size)
    pc = prefix_cache(bm)
    live = {}
    next_id = 0
    for op in script:
        kind = op % 4
        if kind in (0, 1):      # admit: small alphabet -> frequent hits
            length = 1 + (op // 4) % (3 * block_size + 2)
            toks = [((op // 7) + i) % 5 for i in range(length)]
            blocks, hit = pc.match(toks)
            need = bm.blocks_for_tokens(length) - len(blocks)
            if hit < len(blocks) * block_size:
                need += 1       # CoW fork of the trimmed tail
            gate = dict(hit_blocks=blocks) if hit_aware else {}
            if not bm.can_allocate_blocks(need, watermark=False, **gate):
                continue
            rid, next_id = next_id, next_id + 1
            bm.share(rid, blocks)
            bm.ensure(rid, length)
            bm.prepare_write(rid, hit, length)   # what the engine forks
            live[rid] = toks
        elif kind == 2 and live:                 # commit + retire one
            rid = sorted(live)[op % len(live)]
            toks = live.pop(rid)
            pc.commit(toks, bm.table(rid))
            bm.free(rid)
            assert bm.free(rid) == 0             # idempotent double-free
        elif kind == 3:                          # pool pressure
            pc.evict(1 + op % 3)
        assert bm.n_free + bm.n_referenced == bm.n_usable
        for rid in live:                         # eviction safety
            for b in bm.table(rid):
                assert bm.refcount(b) >= 1
                assert b != bm.scratch_block
    for rid in list(live):
        bm.free(rid)
    pc.evict(len(pc) + 1)                        # everything is evictable now
    assert pc.n_evictable == 0 and len(pc) == 0
    assert bm.n_referenced == 0
    assert bm.n_free == bm.n_usable
    assert len(set(bm._free)) == bm.n_usable     # each block back ONCE


def test_admission_example_raises_in_jax_not_in_the_port():
    """Step 4 of the first example hits a block that only the cache
    holds, with no block free: the JAX gate counts that block as
    reclaimable, the share pins it, and ``ensure`` finds nothing.  The
    port's gate defers the admission and keeps the pool's books.  The
    second example (block size 1) fails the JAX gate the same way."""
    with pytest.raises(JaxPoolExhausted, match="need 1 blocks, 0 free"):
        _lifecycle(JaxBlockManager, JaxPrefixCache, hit_aware=False,
                   **ADMISSION_EXAMPLE)
    _lifecycle(BlockManager, PrefixCache, hit_aware=True,
               **ADMISSION_EXAMPLE)
    with pytest.raises(JaxPoolExhausted, match="need 3 blocks, 1 free"):
        _lifecycle(JaxBlockManager, JaxPrefixCache, hit_aware=False,
                   **ADMISSION_EXAMPLE_2)
    _lifecycle(BlockManager, PrefixCache, hit_aware=True,
               **ADMISSION_EXAMPLE_2)


def _gate_scenario(bm_cls, pc_cls, sched_cls, req_cls):
    """One block holds a finished prompt's KV and only the cache holds it;
    a second request takes the other two blocks; then a prompt arrives
    whose only hit is that cache-only block, with no block free.  Returns
    (whether that prompt was admitted at its first chance, whether every
    request finished, whether the books held after every plan)."""
    bm = bm_cls(4, 6)
    pc = pc_cls(bm)
    sched = sched_cls(n_slots=2, max_decodes=1, chunk_size=16,
                      block_manager=bm, prefix_cache=pc, admit_backoff=False)
    sched.submit(req_cls(prompt=[0, 1, 2, 3, 4, 0], max_new_tokens=1,
                         req_id=0))
    sched.next_plan()
    sched.on_tokens({0: 7})                    # finishes, commits block
    assert len(pc) == 1 and pc.n_evictable == 1
    sched.submit(req_cls(prompt=list(range(10, 22)), max_new_tokens=4,
                         req_id=1))
    sched.next_plan()
    assert bm.n_free == 0
    sched.submit(req_cls(prompt=[0, 1, 2, 3, 4, 0, 9], max_new_tokens=1,
                         req_id=2))
    admitted = []
    tokens, books, first_chance = {1: 5}, True, None
    for _ in range(12):
        sched.on_tokens(tokens)
        plan = sched.next_plan(admit_hook=lambda r: admitted.append(r))
        if first_chance is None:
            first_chance = bool(admitted)
        if plan is None:
            break
        books &= bm.n_free + bm.n_referenced == bm.n_usable
        tokens = {d.req_id: 5 for d in plan.decodes}
        tokens.update({c.req_id: 6 for c in plan.chunks if c.is_last})
    return first_chance, not sched.has_work, books


def test_budget_gate_defers_the_example_admission():
    """The example's state through the budget schedulers: the JAX gate
    admits the prompt against the cache-only block it is about to pin
    (and has to preempt it again in the same plan); the port's gate leaves
    it queued until a block is free.  Both finish every request with the
    books kept."""
    from repro.scheduler import SarathiServeScheduler as JaxSched
    from repro_torch.scheduler import SarathiServeScheduler
    want = _gate_scenario(JaxBlockManager, JaxPrefixCache, JaxSched,
                          JaxRequest)
    got = _gate_scenario(BlockManager, PrefixCache, SarathiServeScheduler,
                         Request)
    assert want == (True, True, True)
    assert got == (False, True, True)


@given(n_blocks=st.integers(min_value=4, max_value=48),
       block_size=st.integers(min_value=1, max_value=8),
       script=st.lists(st.integers(min_value=0, max_value=9999),
                       min_size=4, max_size=40))
@example(**ADMISSION_EXAMPLE)
@example(**ADMISSION_EXAMPLE_2)
@settings(max_examples=60, deadline=None, derandomize=True, database=None)
def test_refcount_conservation_under_random_lifecycle(n_blocks, block_size,
                                                      script):
    """The port's copy of the JAX package's property test, with the fixed
    gate: random admit/commit/free/evict interleavings keep the books
    (``n_free + n_referenced == n_usable`` after every operation,
    eviction never reclaims a block of a live table, every block returns
    to the free list exactly once) and never exhaust the pool."""
    _lifecycle(BlockManager, PrefixCache, n_blocks, block_size, script,
               hit_aware=True)
