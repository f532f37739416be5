"""The port's serving simulator and baselines against the JAX package's.

The simulator is the same Python arithmetic over the same cost model and
placement optimizer, so every ``SimResult`` field (each request's
timings, the policy trace, the busy times, the horizon) must be equal
with ``==``: for every mode of ``ALL_MODES`` on the same
``poisson_workload``, PF-High, llama3-70b and llama3-8b, and for the
continuous options (paged, swap, priorities, prefix cache, hot tier,
retrieval shards).  Then the port's counterparts of the simulator
contracts of ``tests/test_serving.py`` and ``tests/test_sharded.py``.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
from repro.configs import get_config as jax_get_config
from repro.core import costmodel as jcm
from repro.core.placement import PlacementOptimizer as JaxOptimizer
from repro.serving import baselines as jbaselines
from repro.serving import simulator as jsimulator

from repro_torch.configs import get_config
from repro_torch.core.costmodel import GB, PF_HIGH, CostModel, ModelProfile
from repro_torch.core.placement import PlacementOptimizer
from repro_torch.serving import SimConfig, poisson_workload
from repro_torch.serving import ServingSimulator as PortSimulator
from repro_torch.serving.baselines import (ALL_MODES, ABLATION_MODES,
                                           BASELINE_MODES, make_simulator,
                                           run_suite)
from repro_torch.serving.request import latency_table
from repro_torch.serving.simulator import rate_at

MODELS = ("llama3-70b", "llama3-8b")
REQ_FIELDS = ("rid", "arrival", "priority", "t_ret_start", "t_ret_end",
              "t_gen_start", "t_gen_end")


def _pair(model="llama3-70b", shards=1):
    """The port's and the JAX package's cost model and optimizer factory
    for ``model`` on PF-High, 32 partitions of 8 GB."""
    kw = dict(partition_bytes=8 * GB, num_partitions=32,
              retrieval_shards=shards)
    cm = CostModel(PF_HIGH, ModelProfile.from_config(get_config(model)), **kw)
    jc = jcm.CostModel(jcm.PF_HIGH,
                       jcm.ModelProfile.from_config(jax_get_config(model)),
                       **kw)
    return ((cm, lambda: PlacementOptimizer(cm, 512, 32)),
            (jc, lambda: JaxOptimizer(jc, 512, 32)))


def _jax_config(sim: SimConfig):
    return jsimulator.SimConfig(**dataclasses.asdict(sim))


def _assert_same(got, want):
    assert len(got.requests) == len(want.requests)
    for r, j in zip(got.requests, want.requests):
        for name in REQ_FIELDS:
            assert getattr(r, name) == getattr(j, name), (r.rid, name)
    assert got.policy_trace == want.policy_trace
    assert (got.gpu_busy, got.cpu_busy, got.horizon) \
        == (want.gpu_busy, want.cpu_busy, want.horizon)
    assert (got.gpu_idle_frac, got.cpu_idle_frac) \
        == (want.gpu_idle_frac, want.cpu_idle_frac)


def test_workload_and_rates_equal_the_reference():
    for seed in (0, 3):
        args = dict(rates_per_min=(4, 8, 12, 16), interval_s=300.0,
                    seed=seed)
        assert poisson_workload(**args) == jsimulator.poisson_workload(**args)
    for t in (0.0, 299.0, 300.0, 1e6):
        assert rate_at(t, (4, 8), 300.0) == jsimulator.rate_at(t, (4, 8),
                                                               300.0)
    assert (ALL_MODES, BASELINE_MODES, ABLATION_MODES) == (
        jbaselines.ALL_MODES, jbaselines.BASELINE_MODES,
        jbaselines.ABLATION_MODES)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("mode", ALL_MODES)
def test_every_mode_equals_the_reference(mode, model):
    (cm, opt_f), (jc, jopt_f) = _pair(model)
    arr = poisson_workload(rates_per_min=(6, 12), interval_s=240, seed=1)
    got = make_simulator(cm, opt_f(), mode).run(list(arr))
    want = jbaselines.make_simulator(jc, jopt_f(), mode).run(list(arr))
    assert len(got.requests) == len(arr)
    _assert_same(got, want)


OPTIONS = {
    "whole-batch": dict(continuous=False),
    "paged": dict(paged=True),
    "paged-int8": dict(paged=True, kv_format="int8"),
    "swap": dict(paged=True, swap=True, partial_swap=True,
                 overlap_swap=True),
    "priority": dict(paged=True, swap=True, priority_mix=0.3),
    "prefix": dict(paged=True, prefix_cache=True, shared_prefix_len=256),
    "hot-tier": dict(paged=True, hot_tier=True),
    "shards": dict(retrieval_shards=4),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_ragdoll_options_equal_the_reference(option):
    (cm, opt_f), (jc, jopt_f) = _pair("llama3-8b")
    arr = poisson_workload(rates_per_min=(8, 16), interval_s=180, seed=2)
    base = SimConfig(**OPTIONS[option])
    got = make_simulator(cm, opt_f(), "ragdoll", base).run(list(arr))
    want = jbaselines.make_simulator(jc, jopt_f(), "ragdoll",
                                     _jax_config(base)).run(list(arr))
    _assert_same(got, want)


def test_run_suite_equals_the_reference():
    (cm, opt_f), (jc, jopt_f) = _pair()
    arr = poisson_workload(rates_per_min=(8, 16), interval_s=120, seed=5)
    modes = ("ragdoll", "serial_vllm", "static_batch")
    got = run_suite(cm, opt_f, arr, modes=modes)
    want = jbaselines.run_suite(jc, jopt_f, arr, modes=modes)
    assert list(got) == list(want) == list(modes)
    for mode in modes:
        _assert_same(got[mode], want[mode])


def test_simulator_class_is_the_ports():
    (cm, opt_f), _ = _pair()
    sim = make_simulator(cm, opt_f(), "static_batch")
    assert isinstance(sim, PortSimulator)
    assert sim.sim.static_batch == sim.sim.max_batch


# ------------------------------------- the reference's simulator contracts
def _sim_setup(model="llama3-70b"):
    return _pair(model)[0]


def test_simulator_conservation_and_accounting():
    cm, opt_f = _sim_setup()
    arr = poisson_workload(rates_per_min=(6, 12), interval_s=300, seed=1)
    res = make_simulator(cm, opt_f(), "ragdoll").run(arr)
    assert len(res.requests) == len(arr)
    assert len({r.rid for r in res.requests}) == len(arr)
    for r in res.requests:
        assert r.t_ret_start >= r.arrival - 1e-9
        assert r.t_gen_start >= r.t_ret_end - 1e-9
        assert abs((r.waiting + r.retrieval + r.generation) - r.latency) \
            < 1e-6


def test_ragdoll_beats_serial_under_load():
    cm, opt_f = _sim_setup()
    arr = poisson_workload(rates_per_min=(8, 16), interval_s=600, seed=2)
    res = run_suite(cm, opt_f, arr,
                    modes=("ragdoll", "serial_vllm", "serial_acc"))
    lat = {m: latency_table(r.requests)["avg_latency"]
           for m, r in res.items()}
    assert lat["ragdoll"] < lat["serial_vllm"]
    assert lat["ragdoll"] < lat["serial_acc"]
    wait = {m: latency_table(r.requests)["avg_waiting"]
            for m, r in res.items()}
    assert wait["ragdoll"] < 0.7 * wait["serial_vllm"]


def test_ablation_ordering():
    cm, opt_f = _sim_setup()
    arr = poisson_workload(rates_per_min=(8, 16), interval_s=600, seed=3)
    res = run_suite(cm, opt_f, arr,
                    modes=("ragdoll", "no_pipeline", "flexgen_prefetch"))
    lat = {m: latency_table(r.requests)["avg_latency"]
           for m, r in res.items()}
    assert lat["ragdoll"] <= lat["no_pipeline"] * 1.05
    assert lat["ragdoll"] <= lat["flexgen_prefetch"] * 1.05


def test_policy_trace_recorded():
    cm, opt_f = _sim_setup()
    arr = poisson_workload(rates_per_min=(4, 16), interval_s=300, seed=4)
    res = make_simulator(cm, opt_f(), "ragdoll").run(arr)
    assert len(res.policy_trace) > 0
    for ev in res.policy_trace:
        assert ev["batch"] >= 1 and ev["P"] >= 0


def test_ragdoll_mode_defaults_to_continuous():
    cm, opt_f = _sim_setup()
    assert make_simulator(cm, opt_f(), "ragdoll").continuous
    assert not make_simulator(cm, opt_f(), "ragdoll",
                              continuous=False).continuous
    for mode in BASELINE_MODES + ABLATION_MODES:
        assert not make_simulator(cm, opt_f(), mode).continuous


def test_continuous_sim_conservation():
    cm, opt_f = _sim_setup()
    arr = poisson_workload(rates_per_min=(6, 12), interval_s=300, seed=5)
    res = make_simulator(cm, opt_f(), "ragdoll", continuous=True).run(arr)
    assert len(res.requests) == len(arr)
    assert len({r.rid for r in res.requests}) == len(arr)
    for r in res.requests:
        assert r.t_ret_start >= r.arrival - 1e-9
        assert r.t_gen_start >= r.t_ret_end - 1e-9
        assert r.t_gen_end > r.t_gen_start
        assert abs((r.waiting + r.retrieval + r.generation) - r.latency) \
            < 1e-6


def test_continuous_beats_whole_batch_under_load():
    cm, opt_f = _sim_setup()
    arr = poisson_workload(rates_per_min=(8, 16), interval_s=600, seed=6)
    cont = make_simulator(cm, opt_f(), "ragdoll", continuous=True).run(arr)
    whole = make_simulator(cm, opt_f(), "ragdoll",
                           continuous=False).run(list(arr))
    t_c = latency_table(cont.requests)
    t_w = latency_table(whole.requests)
    assert t_c["avg_latency"] < t_w["avg_latency"]
    assert t_c["avg_waiting"] < t_w["avg_waiting"]


def test_continuous_policy_acts_mid_generation():
    cm, opt_f = _sim_setup()
    arr = poisson_workload(rates_per_min=(8, 16), interval_s=300, seed=7)
    cont = make_simulator(cm, opt_f(), "ragdoll", continuous=True).run(arr)
    whole = make_simulator(cm, opt_f(), "ragdoll",
                           continuous=False).run(list(arr))
    assert len(cont.policy_trace) > 2 * len(whole.policy_trace)
    for ev in cont.policy_trace:
        assert ev["batch"] >= 1 and ev["P"] >= 0 and "backlog" in ev


def test_simulator_sharded_retrieval_is_not_slower():
    """``tests/test_sharded.py``: four retrieval shards take no longer
    than one, by the simulator's own cost model."""
    arr = poisson_workload(rates_per_min=(6, 12), interval_s=120, seed=0)
    lat = {}
    for shards in (1, 4):
        cm, opt_f = _pair(shards=shards)[0]
        res = make_simulator(cm, opt_f(), "ragdoll").run(list(arr))
        assert len(res.requests) == len(arr)
        lat[shards] = np.mean([r.retrieval for r in res.requests])
    assert lat[4] <= lat[1] * 1.05, lat
