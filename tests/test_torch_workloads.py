"""The port's workload registry, drift, curriculum jobsets and sweep
harness against the JAX package's: the same scenario names and families,
identical jobs (and fault plans) for every registered scenario, SWF
replay, jobsets, drift transforms, drift phases and sweeps under FCFS,
training mixes, service-routed scenario replay and ``encoding_for``."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

import repro.workloads as jwl
import repro_torch.workloads as twl
from _torch_parity import (PKGS, agent_pair, assert_results_equal, job_rows,
                           result_rows, values_and_margin)
from repro.core import FCFSPolicy as JFCFS
from repro.core import encoding_for as jencoding_for
from repro.serve import DecisionService as JService
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServiceSim as JServiceSim
from repro_torch.core import FCFSPolicy, encoding_for
from repro_torch.serve import (DecisionService, ServeConfig, ServicePolicy,
                               ServiceSim)
from repro_torch.sim import Cluster

JSIM = PKGS["jax"]
WL = {"jax": jwl, "torch": twl}
SWF = Path(__file__).parent / "data" / "sample.swf"
# tests/test_registry.py's capacity-invariant scale.
CFG = {pkg: wl.ThetaConfig.mini(seed=0, duration_days=1.5, jobs_per_day=150)
       for pkg, wl in WL.items()}
# The default registrations: other test files add to the JAX package's
# registry as they run, so its names are taken at import.
DEFAULT_NAMES = jwl.scenario_names()


@pytest.fixture
def own_registries(monkeypatch):
    """Registrations made by a test stay within it, in both packages."""
    for wl in WL.values():
        monkeypatch.setattr(wl.registry, "_REGISTRY",
                            dict(wl.registry._REGISTRY))


def spec_row(spec):
    """Everything a ScenarioSpec declares but its build function."""
    return (spec.name, spec.description, spec.family, spec.params,
            None if spec.drift is None else dataclasses.asdict(spec.drift),
            spec.power,
            None if spec.faults is None else dataclasses.asdict(spec.faults),
            spec.tags)


def test_scenario_names_and_families_match():
    def defaults(names):
        return [n for n in names if n in DEFAULT_NAMES]
    assert twl.scenario_names() == DEFAULT_NAMES
    assert len(DEFAULT_NAMES) == 25
    for family in ("paper", "base", "synthetic", "drift", "workflow",
                   "faulty"):
        assert twl.scenario_names(family=family) == \
            defaults(jwl.scenario_names(family=family))
        assert twl.scenario_names(family=family), family
    for tag in ("power", "huge-queue", "requeue", "deps"):
        assert twl.scenario_names(tag=tag) == \
            defaults(jwl.scenario_names(tag=tag))


@pytest.mark.parametrize("name", DEFAULT_NAMES)
def test_every_scenario_builds_identical_jobs(name):
    """The same spec, and at seeds 1 and 2 the same jobs: jid, submit,
    runtime, walltime, demands, workflow dependencies, think times and
    failure points; the fault plan rides on the spec."""
    assert spec_row(twl.get_scenario(name)) == spec_row(jwl.get_scenario(name))
    for seed in (1, 2):
        got = twl.build_jobs(name, CFG["torch"], seed=seed)
        want = jwl.build_jobs(name, CFG["jax"], seed=seed)
        assert len(got) > 0
        assert job_rows(got) == job_rows(want)


def test_build_many_and_overrides_match():
    names = ("S3", "diurnal-heavy", "workflow-pipelines")
    got = twl.build_many(names, CFG["torch"], seed=2)
    want = jwl.build_many(names, CFG["jax"], seed=2)
    assert list(got) == list(want)
    for n in names:
        assert job_rows(got[n]) == job_rows(want[n])
    kw = dict(campaign_mean=3.0, within_gap_s=30.0)
    assert job_rows(twl.build_jobs("bursty-campaigns", CFG["torch"], **kw)) \
        == job_rows(jwl.build_jobs("bursty-campaigns", CFG["jax"], **kw))


def test_registration_rules(own_registries):
    spec = twl.get_scenario("S1")
    with pytest.raises(ValueError, match="already registered"):
        twl.register(spec)
    twl.register(spec, overwrite=True)
    with pytest.raises(KeyError, match="drift-bb-surge"):
        twl.get_scenario("no-such-scenario")
    twl.register(twl.ScenarioSpec(
        name="test-port-custom", family="synthetic",
        build=lambda cfg, seed: twl.generate_trace(cfg)[:5],
        description="tiny custom scenario"), overwrite=True)
    assert len(twl.build_jobs("test-port-custom", CFG["torch"])) == 5


def test_register_swf_replays_the_fixture(own_registries):
    specs = [WL[p].register_swf("swf-port-fixture", str(SWF), overwrite=True)
             for p in ("torch", "jax")]
    assert spec_row(specs[0]) == spec_row(specs[1])
    assert specs[0].family == "swf"
    got = twl.build_jobs("swf-port-fixture", CFG["torch"], seed=1)
    assert [j.jid for j in got] == [1, 5, 2, 3, 6, 9]
    assert job_rows(got) == job_rows(
        jwl.build_jobs("swf-port-fixture", CFG["jax"], seed=9))


def test_jobsets_and_curriculum_match():
    def build(pkg):
        wl = WL[pkg]
        cfg = wl.ThetaConfig.mini(seed=0, duration_days=2)
        trace = wl.generate_trace(cfg)
        return trace, wl.build_curriculum(cfg, trace, n_sampled=2, n_real=2,
                                          n_synth=2, jobs_per_set=60, seed=3)
    (tt, tc), (jt, jc) = build("torch"), build("jax")
    for order in ("sampled_real_synthetic", "synthetic_sampled_real",
                  "real"):
        got, want = tc.ordered(order), jc.ordered(order)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert job_rows(a) == job_rows(b)
    assert [job_rows(s) for s in twl.real_jobsets(tt, 3, 40)] == \
        [job_rows(s) for s in jwl.real_jobsets(jt, 3, 40)]
    # Renumbering remaps workflow edges; a sampled DAG keeps only kept ones.
    dag = {p: WL[p].build_jobs("workflow-ensembles", CFG[p], seed=1)
           for p in WL}
    assert [job_rows(s) for s in twl.sampled_jobsets(dag["torch"], 2, 50)] \
        == [job_rows(s) for s in jwl.sampled_jobsets(dag["jax"], 2, 50)]


SCHEDULES = {
    "step": lambda wl: wl.step_schedule(at=0.4, bb_fraction=0.7,
                                        node_scale=1.3, rate_scale=1.5),
    "ramp": lambda wl: wl.DriftSchedule(mode="ramp", phases=(
        wl.DriftPhase(start=0.0, bb_fraction=0.1, fail_fraction=0.0),
        wl.DriftPhase(start=0.6, bb_fraction=0.9, bb_scale=1.5,
                      fail_fraction=0.4),
        wl.DriftPhase(start=1.0, rate_scale=3.0, node_scale=0.5))),
}


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_drift_transforms_match(kind):
    """``params_at`` over the span, ``apply_drift`` and ``segment_jobs``
    (rebased or not) give the reference's values and jobs."""
    ts, js = SCHEDULES[kind](twl), SCHEDULES[kind](jwl)
    for frac in np.linspace(-0.1, 1.1, 13):
        assert ts.params_at(frac) == js.params_at(frac)
    tjobs = twl.apply_drift(twl.generate_trace(CFG["torch"]), ts,
                            CFG["torch"], seed=5)
    jjobs = jwl.apply_drift(jwl.generate_trace(CFG["jax"]), js, CFG["jax"],
                            seed=5)
    assert job_rows(tjobs) == job_rows(jjobs)
    for rebase in (True, False):
        assert [job_rows(s) for s in twl.segment_jobs(tjobs, 3, rebase)] == \
            [job_rows(s) for s in jwl.segment_jobs(jjobs, 3, rebase)]
    assert twl.apply_drift([], ts, CFG["torch"]) == []
    with pytest.raises(ValueError, match="first at 0"):
        twl.DriftSchedule(phases=(twl.DriftPhase(start=0.2),))
    with pytest.raises(ValueError, match="fail_fraction"):
        twl.DriftPhase(start=0.0, fail_fraction=1.5)


def phases(pkg):
    wl = WL[pkg]
    cfg = wl.ThetaConfig.mini(seed=0, duration_days=1.0, jobs_per_day=120)
    segs = wl.segment_jobs(wl.build_jobs("drift-bb-surge", cfg, seed=1), 2)
    return cfg.resources(), [segs, segs[::-1], [[], segs[0]]]


def test_run_phases_matches_reference():
    """Three lanes walk their phases through the refill hook (one with an
    empty phase skipped): the same (env, phase) order and results."""
    tres, tph = phases("torch")
    jres, jph = phases("jax")
    rounds = []
    got = twl.run_phases(FCFSPolicy(), tres, tph,
                         on_round=lambda r, n: rounds.append(n))
    want = jwl.run_phases(JFCFS(), jres, jph)
    assert [(p.env, p.phase) for p in got] == [(p.env, p.phase) for p in want]
    assert len(got) == 5 and max(rounds) == 3
    for a, b in zip(got, want):
        assert result_rows(a.result) == result_rows(b.result)
    with pytest.raises(ValueError, match="policy_factory"):
        twl.run_phases(_Sequential(), tres, tph)
    lanes = twl.run_phases(None, tres, tph[:2], policy_factory=FCFSPolicy)
    assert [(p.env, p.phase, result_rows(p.result)) for p in lanes] == \
        [(p.env, p.phase, result_rows(p.result)) for p in got if p.env < 2]


class _Sequential:
    def select(self, ctx):
        return 0


def test_build_sweep_and_train_mix_match():
    def build(pkg):
        wl = WL[pkg]
        cfg = wl.ThetaConfig.mini(seed=0, duration_days=0.3, jobs_per_day=80)
        return (wl.build_sweep(cfg, scenarios=("S1", "S4"), seeds=(1, 2),
                               power=True),
                wl.build_train_mix(cfg, scenarios=("S1", "S2", "S3"),
                                   seeds=(1, 2), n_envs=4,
                                   resource_scales=(1.0, 0.75, 0.5)))
    (tsweep, tmix), (jsweep, jmix) = build("torch"), build("jax")
    assert [(t.scenario, t.seed) for t, _ in tsweep] == \
        [(t.scenario, t.seed) for t, _ in jsweep]
    for (_, a), (_, b) in zip(tsweep, jsweep):
        assert job_rows(a) == job_rows(b)
    assert [s.tag for s in tmix] == [s.tag for s in jmix] == \
        ["env0@1x", "env1@0.75x", "env2@0.5x", "env3@1x"]
    for a, b in zip(tmix, jmix):
        assert [(r.name, r.capacity, r.unit) for r in a.resources] == \
            [(r.name, r.capacity, r.unit) for r in b.resources]
        assert [label for label, _ in a.jobsets] == \
            [label for label, _ in b.jobsets]
        for (_, x), (_, y) in zip(a.jobsets, b.jobsets):
            assert job_rows(x) == job_rows(y)
    with pytest.raises(ValueError, match="scale"):
        twl.scale_resources(tmix[0].resources, 1.5)


def test_run_sweep_rows_match_across_modes_and_packages():
    """Sequential and 4-lane sweeps give the same task rows, and so does
    the JAX package; the lockstep engine's statistics are reported."""
    def sweep(pkg, vector):
        wl = WL[pkg]
        cfg = wl.ThetaConfig.mini(seed=0, duration_days=0.4, jobs_per_day=100)
        tasks = wl.build_sweep(cfg, scenarios=("S1", "S2", "S5"),
                               seeds=(1, 2))
        policy = FCFSPolicy() if pkg == "torch" else JFCFS()
        return wl.run_sweep(cfg.resources(), tasks, policy, vector=vector)
    seq, vec = sweep("torch", 0), sweep("torch", 4)
    jseq, jvec = sweep("jax", 0), sweep("jax", 4)
    assert (seq["mode"], vec["mode"]) == ("sequential", "vector4")
    assert seq["tasks"] == vec["tasks"] == jseq["tasks"] == jvec["tasks"]
    assert seq["decisions"] == vec["decisions"] > 0
    assert vec["vector_stats"] == jvec["vector_stats"]
    assert len(vec["vector_stats"]) == 2 and "vector_stats" not in seq
    timing = {"wall_seconds", "decisions_per_sec"}
    assert {k: v for k, v in vec.items() if k not in timing} == \
        {k: v for k, v in jvec.items() if k not in timing}


class _RecordingPolicy(ServicePolicy):
    """Keeps every served packed row, for the margin check."""

    def __init__(self, service):
        super().__init__(service)
        self.rows = []

    def select(self, ctx):
        self.rows.append(self.service._encode(ctx))
        return super().select(ctx)


def test_run_scenario_and_encoding_for_match():
    """A registry scenario replayed through each package's service from
    the same weights: the same result, no served row within a 1e-5 top-2
    margin; ``encoding_for`` builds the reference's encoding."""
    cfg = {p: WL[p].ThetaConfig.mini(seed=0, duration_days=0.25,
                                     jobs_per_day=160) for p in WL}
    ja, ta = agent_pair(cfg["jax"].resources())
    with JService(ja, JServeConfig(max_batch=4)) as svc:
        want = JServiceSim(svc, cfg["jax"].resources()).run_scenario(
            "faulty-jobs", cfg["jax"], seed=2)
    with DecisionService(ta, ServeConfig(max_batch=4)) as svc:
        ssim = ServiceSim(svc, cfg["torch"].resources())
        ssim.policy = _RecordingPolicy(svc)
        got = ssim.run_scenario("faulty-jobs", cfg["torch"], seed=2)
    assert got.decisions > 20
    assert_results_equal(got, want)
    margin = values_and_margin(ta, np.stack(ssim.policy.rows))[1]
    margin = margin[np.isfinite(margin)]
    assert margin.size > 0 and margin.min() > 1e-5
    cluster = Cluster(cfg["torch"].resources())
    jcluster = JSIM.Cluster(cfg["jax"].resources())
    for kw in ({}, {"state_module": "attention", "queue_cap": 12,
                    "time_scale": 3600.0}):
        enc = encoding_for(cluster, 10, **kw)
        assert dataclasses.asdict(enc) == \
            dataclasses.asdict(jencoding_for(jcluster, 10, **kw))
        assert enc.state_dim == jencoding_for(jcluster, 10, **kw).state_dim
    assert encoding_for(cluster, 10).state_dim == ta.enc.state_dim
