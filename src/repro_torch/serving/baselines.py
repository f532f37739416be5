"""Baseline/ablation construction helpers (paper §6.1 baselines, §6.4).

Copied from ``repro.serving.baselines`` onto the port's simulator.

Each entry returns a configured ``ServingSimulator`` for one row of the
evaluation: the serial vLLMRAG / AccRAG baselines and the Table 2
ablations of RAGDoll's own components.  Only the "ragdoll" mode uses
continuous decode-step batching; the serial baselines and ablations keep
whole-batch semantics so Fig. 9 / benchmark comparisons are like-for-like
(pass ``continuous=False`` to get the whole-batch ragdoll variant).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.costmodel import CostModel
from repro_torch.core.placement import PlacementOptimizer
from repro_torch.serving.simulator import ServingSimulator, SimConfig

BASELINE_MODES = ("serial_vllm", "serial_acc")
ABLATION_MODES = ("no_pipeline", "static_batch", "flexgen_prefetch",
                  "vllm_infer")
ALL_MODES = ("ragdoll",) + BASELINE_MODES + ABLATION_MODES


def make_simulator(cost: CostModel, opt: PlacementOptimizer, mode: str,
                   base: Optional[SimConfig] = None,
                   **overrides) -> ServingSimulator:
    assert mode in ALL_MODES, mode
    sim = dataclasses.replace(base or SimConfig(), mode=mode, **overrides)
    if mode == "static_batch" and sim.static_batch is None:
        sim = dataclasses.replace(sim, static_batch=sim.max_batch)
    return ServingSimulator(cost, opt, sim)


def run_suite(cost: CostModel, opt_factory, arrivals,
              modes=ALL_MODES, base: Optional[SimConfig] = None
              ) -> Dict[str, object]:
    """Run several modes on the same workload; fresh optimizer per mode."""
    out = {}
    for mode in modes:
        sim = make_simulator(cost, opt_factory(), mode, base)
        out[mode] = sim.run(list(arrivals))
    return out
