"""The port's ``sarathi_serve`` token-budget scheduler against the JAX
package's, with no engine: on fixed-seed request streams both must emit
the same plans (chunks, decodes, preemptions) and finish the same
requests, with no block pool, a roomy pool, a tight pool that forces
preemption, a prompt that can never fit (rejected), and a prefix
cache."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.cache import BlockManager as JaxBlockManager  # noqa: E402
from repro.cache import PrefixCache as JaxPrefixCache  # noqa: E402
from repro.scheduler import Request as JaxRequest  # noqa: E402
from repro.scheduler import \
    SarathiServeScheduler as JaxSarathiServeScheduler  # noqa: E402
from repro_torch.cache import BlockManager, PrefixCache  # noqa: E402
from repro_torch.scheduler import (CHUNKED_POLICIES, POLICIES,  # noqa: E402
                                   PREFIX_POLICIES, Request,
                                   SarathiServeScheduler)

JAX = (JaxSarathiServeScheduler, JaxBlockManager, JaxPrefixCache,
       JaxRequest)
PORT = (SarathiServeScheduler, BlockManager, PrefixCache, Request)

CASES = {
    # name: scheduler kwargs, pool (n_blocks, block_size) or None,
    #       prefix cache, prompt lengths, new tokens, seed
    "no_pool": (dict(token_budget=20), None, False, (9, 30, 17, 4, 25, 12),
                6, 0),
    "roomy_pool": (dict(), (64, 4), False, (9, 30, 17, 4, 25, 12), 6, 1),
    "multi_chunk": (dict(token_budget=40, max_chunks_per_iter=3), (64, 4),
                    False, (33, 21, 9, 40, 5), 5, 2),
    "tight_pool": (dict(token_budget=24), (14, 4), False,
                   (14, 20, 11, 18, 9, 16), 12, 3),
    "rejected": (dict(), (12, 4), False, (10, 60, 7, 12), 4, 4),
    "prefix_cache": (dict(token_budget=24), (64, 4), True,
                     (10, 14, 7, 12, 9, 14), 5, 5),
}


def _stream(req_cls, lens, n_new, seed, shared):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 50, 8).tolist() if shared else []
    return [req_cls(prompt=prefix + rng.integers(0, 50, n).tolist(),
                    max_new_tokens=n_new, req_id=i)
            for i, n in enumerate(lens)]


def _drive(impl, case):
    """Run the stream to the end, feeding each sampled position a token
    made from (request, output length); returns every plan and
    preemption in order, the outputs, the rejected ids and the counters."""
    sched_cls, bm_cls, pc_cls, req_cls = impl
    kw, pool, prefix, lens, n_new, seed = CASES[case]
    bm = bm_cls(*pool) if pool else None
    pc = pc_cls(bm) if prefix else None
    sched = sched_cls(n_slots=4, max_decodes=3, chunk_size=8,
                      block_manager=bm, prefix_cache=pc, **kw)
    reqs = _stream(req_cls, lens, n_new, seed, shared=prefix)
    by_id = {r.req_id: r for r in reqs}
    for r in reqs:
        sched.submit(r)
    trace = []
    for _ in range(500):
        plan = sched.next_plan(
            preempt_hook=lambda r: trace.append(("preempt", r.req_id)))
        if plan is None:
            break
        trace.append(([(c.req_id, list(c.tokens), c.start, c.is_last)
                       for c in plan.chunks],
                      [(d.req_id, d.token, d.ctx) for d in plan.decodes]))
        rids = [c.req_id for c in plan.chunks if c.is_last] + \
            [d.req_id for d in plan.decodes]
        sched.on_tokens({rid: (7 * rid + 3 * len(by_id[rid].output)) % 50
                         for rid in rids})
        if bm is not None:
            assert bm.n_free + bm.n_referenced == bm.n_usable
    assert not sched.has_work
    return (trace, [list(r.output) for r in reqs],
            [r.req_id for r in sched.rejected], sched.n_preemptions,
            sched.n_cached_tokens)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plans_match_jax(case):
    want = _drive(JAX, case)
    got = _drive(PORT, case)
    assert got == want
    trace, _, rejected, n_preempt, n_cached = got
    if case == "tight_pool":
        assert n_preempt > 0
    if case == "rejected":
        assert rejected == [1]
    if case == "prefix_cache":
        assert n_cached > 0
    if case == "multi_chunk":
        assert max(len(t[0]) for t in trace if t[0] != "preempt") > 1


def test_policy_sets_match_jax():
    from repro.scheduler import (BUDGETED_POLICIES as J_BUDGETED,
                                 CHUNKED_POLICIES as J_CHUNKED,
                                 POLICIES as J_POLICIES,
                                 PREFIX_POLICIES as J_PREFIX,
                                 SWAP_POLICIES as J_SWAP)
    from repro_torch.scheduler import BUDGETED_POLICIES, SWAP_POLICIES
    assert sorted(POLICIES) == sorted(J_POLICIES)
    assert (CHUNKED_POLICIES, BUDGETED_POLICIES, PREFIX_POLICIES,
            SWAP_POLICIES) == (J_CHUNKED, J_BUDGETED, J_PREFIX, J_SWAP)


@pytest.mark.parametrize("kw", [dict(preempt_mode="swap"),
                                dict(preempt_mode="hybrid"),
                                dict(preempt_mode="bogus")])
def test_swap_modes_raise(kw):
    """Without a host tier the swap modes raise, as an unknown mode does,
    with the JAX scheduler's error."""
    errors = []
    for sched_cls, bm_cls in ((SarathiServeScheduler, BlockManager),
                              (JaxSarathiServeScheduler, JaxBlockManager)):
        with pytest.raises(ValueError) as e:
            sched_cls(n_slots=2, max_decodes=1, chunk_size=8,
                      block_manager=bm_cls(8, 4), **kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
