"""Hardware profiles for the analytical cost model.

Effective efficiencies are calibrated so the model reproduces the paper's
measured LLaMA-13B/A6000 numbers (Table 2): 155 TF fp16 tensor peak at
~0.76 matmul efficiency gives the 224.8 ms linear-op prefill time; 768 GB/s
at ~0.77 gives the 44.3 ms decode weight-fetch time.

A copy of the JAX package's ``repro.sim.hardware``, profiles and all.
Their constants are the cost model's inputs (data sheets and the paper's
calibration), not measurements of this port; there is no H100 profile.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float            # dense fp16/bf16 FLOP/s per chip
    hbm_bw: float                # bytes/s per chip
    link_bw: float               # bytes/s per ICI/NVLink direction
    matmul_eff: float = 0.76     # achieved fraction of peak for big matmuls
    mem_eff: float = 0.77        # achieved fraction of HBM bandwidth
    kernel_overhead: float = 5e-6  # fixed per-op launch/dispatch cost (s)
    tile: int = 128              # matmul tile (thread-block tile / MXU edge)
    hbm_capacity: float = 80e9   # bytes of device memory per chip
    # host<->device bandwidth for the KV swap tier (PCIe 4.0 x16 effective
    # ~25-28 GB/s; we charge the nominal 32 GB/s direction rate and let
    # kernel_overhead absorb the per-transfer setup)
    pcie_bw: float = 32e9        # bytes/s host<->device, per direction

    @property
    def flops_per_byte(self) -> float:
        """The roofline ridge point (paper: ~53 A6000, ~156 A100)."""
        return self.peak_flops / self.hbm_bw


A6000 = Hardware("A6000", peak_flops=155e12, hbm_bw=768e9, link_bw=56e9,
                 hbm_capacity=48e9)
A100 = Hardware("A100-80GB", peak_flops=312e12, hbm_bw=2039e9, link_bw=300e9,
                hbm_capacity=80e9)
# TPU v5e — the deployment target (constants fixed by the assignment).
TPU_V5E = Hardware("TPUv5e", peak_flops=197e12, hbm_bw=819e9, link_bw=50e9,
                   matmul_eff=0.8, mem_eff=0.8, kernel_overhead=2e-6,
                   hbm_capacity=16e9)

PROFILES = {h.name.lower(): h for h in (A6000, A100, TPU_V5E)}
