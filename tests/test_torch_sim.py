"""The port's simulator, lifecycle, metrics, tracer and workloads against
the JAX package's: the same deterministic policy on the same traces gives
identical SimResults, per-job schedules and canonical event streams."""
import pytest

from _torch_parity import (PKGS, TRACERS, SlotPolicy, faulty_mini,
                           job_rows, result_rows, theta_mini)


def _run(pkg, res, jobs, faults=None, rotate=False):
    tracer = TRACERS[pkg].BufferTracer()
    sim = PKGS[pkg].Simulator(res, jobs, SlotPolicy(rotate),
                              PKGS[pkg].SimConfig(), faults=faults,
                              tracer=tracer)
    r = sim.run()
    return r, TRACERS[pkg].canonical_events(tracer.events)


@pytest.mark.parametrize("rotate", [False, True], ids=["slot0", "rotating"])
@pytest.mark.parametrize("scenario", ["S1", "S2", "S3", "S4", "S5"])
def test_theta_mini_scenarios_identical(scenario, rotate):
    (jres, jjobs), (tres, tjobs) = (theta_mini("jax", scenario),
                                    theta_mini("torch", scenario))
    assert job_rows(tjobs) == job_rows(jjobs)          # workloads port
    rj, ej = _run("jax", jres, jjobs, rotate=rotate)
    rt, et = _run("torch", tres, tjobs, rotate=rotate)
    assert rj.decisions > 50
    assert result_rows(rt) == result_rows(rj)
    assert et == ej


@pytest.mark.parametrize("rotate", [False, True], ids=["slot0", "rotating"])
def test_faults_drains_and_requeues_identical(rotate):
    jres, jjobs, jfaults = faulty_mini("jax")
    tres, tjobs, tfaults = faulty_mini("torch")
    rj, ej = _run("jax", jres, jjobs, jfaults, rotate)
    rt, et = _run("torch", tres, tjobs, tfaults, rotate)
    # The fault paths really ran: kills, requeues and terminal failures.
    assert rj.requeues > 0 and rj.n_failed > 0
    kinds = {e["ev"] for e in ej}
    assert {"fault.drain", "fault.restore", "job.requeue",
            "job.fail"} <= kinds
    assert result_rows(rt) == result_rows(rj)
    assert et == ej


def test_workflow_deps_identical():
    """Dependencies with think times (HELD -> ELIGIBLE -> QUEUED)."""
    out = {}
    for pkg, sim in PKGS.items():
        jobs = [sim.Job(0, 0.0, 100.0, 150.0, {"node": 3}),
                sim.Job(1, 5.0, 50.0, 60.0, {"node": 2}, deps=(0,),
                        think_time=30.0),
                sim.Job(2, 10.0, 80.0, 90.0, {"node": 4}),
                sim.Job(3, 12.0, 20.0, 40.0, {"node": 1}, deps=(1, 2)),
                sim.Job(4, 15.0, 30.0, 30.0, {"node": 1}, deps=(9,))]
        out[pkg] = _run(pkg, [sim.ResourceSpec("node", 4)], jobs)
    assert result_rows(out["torch"][0]) == result_rows(out["jax"][0])
    assert out["torch"][1] == out["jax"][1]
    assert out["jax"][0].metrics.pipeline_makespan > 0


def test_sim_config_validation():
    from repro_torch.sim import SimConfig
    with pytest.raises(ValueError, match="window"):
        SimConfig.for_engine(window=0)
    with pytest.raises(ValueError, match="max_events"):
        SimConfig.for_engine(max_events=0)
    with pytest.raises(ValueError, match="engine"):
        SimConfig.for_engine("warp")
    assert SimConfig.for_engine("vector").engine == "vector"
    cfg = SimConfig.for_engine(window=5, backfill=False, max_events=10)
    assert (cfg.window, cfg.backfill, cfg.max_events) == (5, False, 10)
