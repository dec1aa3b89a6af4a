"""The port's analytical cost model and pipeline simulator against the JAX
package's, on the CPU.  Both are pure arithmetic on the same config fields
and hardware constants, so every float must be EQUAL, not merely close:
for each config both registries share and each of the three hardware
profiles, over a grid of batch shapes; and ``simulate_pipeline`` on the
same scheduler and workload must give an equal ``PipelineResult``."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import sim as jsim  # noqa: E402
from repro.sim import cost_model as jcm  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.scheduler import POLICIES as JAX_POLICIES  # noqa: E402
from repro.scheduler import Request as JaxRequest  # noqa: E402
from repro_torch import sim  # noqa: E402
from repro_torch.sim import cost_model as cm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.scheduler import POLICIES, Request  # noqa: E402

PROFILES = sorted(sim.PROFILES)
# (chunk, ctx_start, n_decodes, decode_ctx)
SHAPES = [(1, 0, 0, 1), (256, 0, 7, 512), (250, 1007, 7, 1567),
          (512, 3584, 31, 4096), (0, 0, 16, 2048), (96, 32, 1, 64)]


def _both(arch, profile):
    return ((get_config(arch), sim.PROFILES[profile], cm),
            (jax_config(arch), jsim.PROFILES[profile], jcm))


def _cost_terms(cfg, hw, m):
    """Every entry point of the cost-model module ``m`` over the shape
    grid, as plain floats and tuples."""
    out = []
    for chunk, start, n_dec, dctx in SHAPES:
        for n_chips in (1, 4):
            for fused in (True, False):
                for sp in (False, True):
                    spec = m.BatchSpec(
                        prefills=((m.PrefillSeg(chunk, start),)
                                  if chunk else ()),
                        decodes=((m.DecodeSeg(n_dec, dctx),)
                                 if n_dec else ()), fused=fused)
                    bd = m.iteration_time(cfg, hw, spec, n_chips=n_chips,
                                          sp=sp)
                    out.append(dataclasses.astuple(bd) + (bd.total,))
            out += [m.prefill_time(cfg, hw, max(chunk, 1), start, n_chips),
                    m.decode_time(cfg, hw, max(n_dec, 1), dctx, n_chips),
                    m.hybrid_time(cfg, hw, max(chunk, 1), start, n_dec,
                                  dctx, n_chips),
                    m.chunked_prefill_total(cfg, hw, start + chunk + 1,
                                            max(chunk, 1), n_chips),
                    m.sp_activation_bytes(cfg, chunk + n_dec, n_chips,
                                          sp=True),
                    m.tp_allreduce_time(hw, 1e6 * (chunk + 1), n_chips),
                    m.tp_reduce_scatter_time(hw, 1e6, n_chips),
                    m.tp_all_gather_time(hw, 1e6, n_chips)]
        n_blocks = -(-(start + chunk + 1) // 16)
        nbytes = m.kv_swap_bytes(cfg, n_blocks, 16)
        out += [nbytes, m.kv_swap_time(hw, nbytes),
                m.kv_handoff_bytes(cfg, start + chunk),
                m.kv_transfer_time(hw, nbytes)]
    budget = m.kv_budget_bytes(cfg, hw)
    out += [budget, m.kv_budget_bytes(cfg, hw, n_chips=8),
            m.kv_pool_tokens(cfg, budget), m.dense_capacity(cfg, budget, 2048),
            m.paged_capacity(cfg, budget, 16, 1500), hw.flops_per_byte]
    return out


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cost_model_equals_jax(arch, profile):
    (cfg, hw, m), (cfg_j, hw_j, m_j) = _both(arch, profile)
    assert dataclasses.astuple(hw) == dataclasses.astuple(hw_j)
    got, want = _cost_terms(cfg, hw, m), _cost_terms(cfg_j, hw_j, m_j)
    assert len(got) == len(want) > 100
    assert got == want                      # exact, term by term


def _pipeline(policies, req_cls, sim_pkg, cfg, hw, policy, pp, tp):
    rng = np.random.default_rng(7)
    lens = rng.integers(16, 400, 12)
    reqs = [req_cls(prompt=[1] * int(n), max_new_tokens=int(d), req_id=i)
            for i, (n, d) in enumerate(zip(lens, rng.integers(1, 24, 12)))]
    sched = policies[policy](n_slots=4, max_decodes=3, chunk_size=64)
    for r in reqs:
        sched.submit(r)
    res = sim_pkg.simulate_pipeline(cfg, hw, sched, pp=pp, tp=tp,
                                    sp=tp > 1)
    return (dataclasses.astuple(res), res.total_bubble,
            res.median_request_bubble, res.collective_fraction)


@pytest.mark.parametrize("pp,tp", [(1, 1), (4, 1), (2, 2)])
@pytest.mark.parametrize("policy", ["sarathi", "orca", "sarathi_serve"])
def test_simulate_pipeline_equals_jax(policy, pp, tp):
    (cfg, hw, _), (cfg_j, hw_j, _) = _both("paper-llama-13b", "a100-80gb")
    got = _pipeline(POLICIES, Request, sim, cfg, hw, policy, pp, tp)
    want = _pipeline(JAX_POLICIES, JaxRequest, jsim, cfg_j, hw_j, policy,
                     pp, tp)
    assert got == want
    assert got[0][5] > 0                    # micro-batches ran
