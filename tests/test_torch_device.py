"""The port's device rollout engine (``repro_torch.sim.DeviceSimulator``,
on the CPU) against the JAX package's ``DeviceSimulator`` (XLA backend) on
the same jobsets: the same actions, decided masks and results, for FCFS
and for a small agent on both port backends, with several environments,
backfill off, drains, failure points and workflow deps; plus the port's
engine against its own sequential engine and the decoded event trace."""
import numpy as np
import pytest

import repro.sim as jsim
import repro_torch.sim as tsim
from _torch_parity import (PKGS, SMALL, TRACERS, SlotPolicy, agent_pair,
                           assert_results_close, assert_results_equal,
                           env_actions, faulty_mini, synth_jobs, theta_mini)
from repro.core import FCFSPolicy as JFCFS
from repro_torch.core import FCFSPolicy as TFCFS
from repro_torch.core import supports_batch, supports_device

FCFS = {"jax": JFCFS, "torch": TFCFS}


def res(pkg):
    sim = PKGS[pkg]
    return [sim.ResourceSpec("node", 16), sim.ResourceSpec("bb", 8)]


def rollout(pkg, resources, jobsets, policy, config=None, faults=None,
            **kw):
    sim = PKGS[pkg]
    extra = {"device": "cpu"} if pkg == "torch" else {}
    ds = sim.DeviceSimulator(resources, jobsets, policy, config,
                             faults=faults, **extra)
    return ds, ds.rollout(**kw)


def assert_same_rollout(rj, rt):
    """Identical actions and decided masks; results close env by env."""
    np.testing.assert_array_equal(rt.actions, rj.actions)
    np.testing.assert_array_equal(rt.decided, rj.decided)
    assert len(rt.results) == len(rj.results)
    for a, b in zip(rj.results, rt.results):
        assert_results_close(a, b)


# ------------------------------------------------- port vs reference engine
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fcfs_matches_reference_engine(seed):
    out = {pkg: rollout(pkg, res(pkg), [synth_jobs(PKGS[pkg], seed)],
                        FCFS[pkg]())[1] for pkg in PKGS}
    assert_same_rollout(out["jax"], out["torch"])
    st = out["torch"].stats
    assert st.decisions == out["jax"].stats.decisions > 0
    # One sync per round, plus the backfill loop's tests.
    assert st.rounds_run <= out["torch"].actions.shape[0]
    assert st.rounds_run <= st.host_syncs


def test_small_agent_matches_reference_engine_both_backends():
    ja, ta = agent_pair(res("jax"))
    rj = rollout("jax", res("jax"), [synth_jobs(jsim, 5)], ja)[1]
    for backend in ("torch", "kernel"):
        ta.set_backend(backend)
        rt = rollout("torch", res("torch"), [synth_jobs(tsim, 5)], ta)[1]
        assert_same_rollout(rj, rt)


def test_environments_of_different_lengths():
    """N = 4 jobsets of 10..31 jobs: the job axis is padded to the longest."""
    out = {pkg: rollout(pkg, res(pkg),
                        [synth_jobs(PKGS[pkg], s, n=10 + 7 * s)
                         for s in range(4)], FCFS[pkg]())[1]
           for pkg in PKGS}
    assert_same_rollout(out["jax"], out["torch"])
    assert out["torch"].stats.max_batch > 1


def test_backfill_off_matches_reference_engine():
    out = {pkg: rollout(pkg, res(pkg), [synth_jobs(PKGS[pkg], 3)],
                        FCFS[pkg](),
                        PKGS[pkg].SimConfig.for_engine("device",
                                                       backfill=False))[1]
           for pkg in PKGS}
    assert_same_rollout(out["jax"], out["torch"])


def faulty_workflow_mini(pkg):
    """Mini S1 with failure points, a node drain with a restore, a
    permanent burst-buffer drain, and workflow deps with think times
    (every 6th job waits on the job before it)."""
    resources, jobs, faults = faulty_mini(pkg)
    for prev, job in zip(jobs[5::6], jobs[6::6]):
        job.deps = (prev.jid,)
        job.think_time = 120.0
    return resources, jobs, faults


@pytest.mark.parametrize("policy", ["fcfs", "agent"])
def test_drains_failures_and_deps_match_reference_engine(policy):
    data = {pkg: faulty_workflow_mini(pkg) for pkg in PKGS}
    if policy == "fcfs":
        pols = {pkg: FCFS[pkg]() for pkg in PKGS}
    else:
        pols = dict(zip(("jax", "torch"), agent_pair(data["jax"][0])))
    out = {pkg: rollout(pkg, data[pkg][0], [data[pkg][1]], pols[pkg],
                        faults=data[pkg][2])[1] for pkg in PKGS}
    assert_same_rollout(out["jax"], out["torch"])
    r = out["torch"].results[0]
    assert r.requeues > 0 and r.n_failed > 0          # the paths ran
    assert r.metrics.pipeline_makespan > 0.0


def test_several_backfills_in_one_round_assign_the_same_units():
    """A wide job reserves behind a running one; three of the four short
    jobs queued with it then backfill in the same round (the fourth no
    longer fits).  The port's searchsorted unit assignment
    gives each the units the reference's one-hot contraction gives."""
    jobs = {}
    for pkg, sim in PKGS.items():
        jobs[pkg] = [
            sim.Job(0, 0.0, 500.0, 500.0, {"node": 10, "bb": 2}),
            sim.Job(1, 1.0, 300.0, 400.0, {"node": 12, "bb": 1}),
            sim.Job(2, 1.0, 50.0, 60.0, {"node": 2, "bb": 1}),
            sim.Job(3, 1.0, 40.0, 50.0, {"node": 1, "bb": 2}),
            sim.Job(4, 1.0, 30.0, 40.0, {"node": 3, "bb": 1}),
            sim.Job(5, 1.0, 20.0, 30.0, {"node": 2, "bb": 0}),
        ]
    tracers = {pkg: TRACERS[pkg].BufferTracer() for pkg in PKGS}
    out = {}
    for pkg in PKGS:
        ds, out[pkg] = rollout(pkg, res(pkg), [jobs[pkg]], FCFS[pkg](),
                               trace=True)
        ds.emit_trace(out[pkg], tracers[pkg])
    rt = out["torch"]
    assert_same_rollout(out["jax"], rt)
    fills = [e["n"] for e in tracers["torch"].events
             if e["ev"] == "sched.backfill"]
    assert max(fills) == 3
    assert (TRACERS["torch"].canonical_events(tracers["torch"].events)
            == TRACERS["jax"].canonical_events(tracers["jax"].events))
    starts = {j.jid: j.start for j in rt.results[0].jobs}
    assert starts[2] == starts[3] == starts[4] == 1.0 < starts[5]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_backfill_unit_assignment_matches_reference_one_hot(seed):
    """``_easy_backfill`` on one random mid-run state: the port's
    searchsorted assignment writes the same release times and owners,
    unit for unit, as the reference's dense (N, units, J) one-hot."""
    import jax.numpy as jnp
    import torch

    from repro.sim import device as jdev
    from repro_torch.sim import device as tdev
    rng = np.random.default_rng(seed)
    N, J, caps = 8, 14, (16, 8)
    kw = dict(names=("node", "bb"), caps=caps, enc_caps=caps, window=10,
              n_envs=N, n_jobs=J, rounds=1, backfill=True,
              requires_obs=False, time_scale=86400.0)
    U = sum(caps)
    busy = rng.uniform(size=(N, U)) < 0.4
    release = np.where(busy, rng.integers(10, 500, size=(N, U)),
                       0).astype(np.float32)
    owner = np.where(busy, rng.integers(0, J, size=(N, U)), -1)
    demands = np.stack([rng.integers(0, 4, size=(N, J)),
                        rng.integers(0, 3, size=(N, J))], -1)
    j_star = rng.integers(0, J, size=N)
    demands[np.arange(N), j_star] = (15, 7)            # it must reserve
    demands = demands.astype(np.float32)
    walltime = rng.integers(5, 400, size=(N, J)).astype(np.float32)
    waiting = (rng.uniform(size=(N, J)) < 0.7).astype(np.float32)
    waiting[np.arange(N), j_star] = 1.0
    now = np.full(N, 5.0, np.float32)
    free = np.stack([(release[:, :16] == 0).sum(1),
                     (release[:, 16:] == 0).sum(1)], 1).astype(np.float32)
    state = {"now": now, "release": release, "owner": owner.astype(np.int32),
             "started": np.zeros((N, J), bool),
             "start": np.full((N, J), -1.0, np.float32),
             "end": np.full((N, J), np.inf, np.float32),
             "est_end": np.zeros((N, J), np.float32),
             "first_start_j": np.full((N, J), -1.0, np.float32),
             "first_start": np.full(N, np.inf, np.float32),
             "cur_fail": np.zeros((N, J), bool)}
    args = dict(free=free, need=np.ones(N, bool), waiting=waiting,
                j_star=j_star, d_star=demands[np.arange(N), j_star],
                dur_all=walltime * 0.5)
    arrays = {"demands": demands, "walltime": walltime}
    jax_out = jdev._easy_backfill(
        jdev.DeviceLayout(**kw), {k: jnp.asarray(v) for k, v in arrays.items()},
        {k: jnp.asarray(v) for k, v in state.items()},
        *(jnp.asarray(args[k]) for k in ("free", "need", "waiting",
                                          "j_star", "d_star", "dur_all")),
        None)
    t = torch.from_numpy
    port_out = tdev._easy_backfill(
        tdev.DeviceLayout(**kw), {k: t(v) for k, v in arrays.items()},
        {k: t(np.asarray(v)) for k, v in state.items()},
        *(t(np.asarray(args[k])) for k in ("free", "need", "waiting")),
        t(j_star).long(), t(args["d_star"]), t(args["dur_all"]), None,
        tdev._SyncCounter())
    for key in ("release", "owner", "started", "start", "end", "est_end",
                "first_start_j", "first_start"):
        np.testing.assert_array_equal(port_out[key].numpy(),
                                      np.asarray(jax_out[key]), err_msg=key)
    # Several environments backfilled several jobs in this one call.
    assert (port_out["started"].numpy().sum(axis=1) >= 2).sum() >= 2


# ---------------------------------------------- port device vs port host
@pytest.mark.parametrize("policy", ["fcfs", "agent"])
def test_device_equals_sequential_engine(policy):
    """The N = 1 pin inside the port: the device engine reproduces the
    sequential engine decision for decision."""
    resources, jobs = theta_mini("torch", "S2", days=0.5)
    if policy == "fcfs":
        pol = TFCFS()
    else:
        pol = agent_pair(resources)[1]

    class Recorder:
        def __init__(self):
            self.actions = []

        def select(self, ctx):
            self.actions.append(int(pol.select(ctx)))
            return self.actions[-1]

    rec = Recorder()
    seq = tsim.Simulator(resources, jobs, rec, tsim.SimConfig()).run()
    ro = rollout("torch", resources, [jobs], pol)[1]
    assert env_actions(ro, 0) == rec.actions
    assert_results_close(seq, ro.results[0])


def _integer_fault_trace(sim):
    """tests/test_obs.py's fault-path trace: requeue, fail, drain and
    restore, and a dependency release, all at integer times."""
    jobs = [
        sim.Job(jid=1, submit=0.0, runtime=100.0, walltime=200.0,
                demands={"node": 4}),
        sim.Job(jid=2, submit=0.0, runtime=400.0, walltime=500.0,
                demands={"node": 6}, fail_times=(50.0,)),
        sim.Job(jid=3, submit=10.0, runtime=300.0, walltime=400.0,
                demands={"node": 8}),
        sim.Job(jid=4, submit=20.0, runtime=50.0, walltime=100.0,
                demands={"node": 2}, deps=(1,), think_time=30.0),
        sim.Job(jid=5, submit=30.0, runtime=200.0, walltime=250.0,
                demands={"node": 4},
                fail_times=(20.0, 20.0, 20.0, 20.0, 20.0)),
        sim.Job(jid=6, submit=40.0, runtime=80.0, walltime=120.0,
                demands={"node": 3}),
    ]
    faults = sim.FaultSchedule(
        drains=(sim.DrainEvent(time=120.0, resource="node", units=6,
                               duration=200.0),),
        max_requeues=2)
    return [sim.ResourceSpec("node", 12)], jobs, faults


def test_emit_trace_matches_sequential_engine():
    events = {}
    for pkg in PKGS:
        resources, jobs, faults = _integer_fault_trace(PKGS[pkg])
        tr = TRACERS[pkg]
        t_seq, t_dev = tr.BufferTracer(), tr.BufferTracer()
        PKGS[pkg].Simulator(resources, jobs, FCFS[pkg](),
                            PKGS[pkg].SimConfig(), faults=faults,
                            tracer=t_seq).run()
        ds, ro = rollout(pkg, resources, [jobs], FCFS[pkg](), faults=faults,
                         trace=True)
        ds.emit_trace(ro, t_dev)
        events[pkg] = (tr.canonical_events(t_seq.events),
                       tr.canonical_events(t_dev.events))
    assert events["torch"][1] == events["torch"][0]     # port: dev == seq
    assert events["torch"][1] == events["jax"][1]       # port == reference
    kinds = {}
    for e in events["torch"][1]:
        kinds[e["ev"]] = kinds.get(e["ev"], 0) + 1
    assert kinds == {"job.queued": 10, "sched.decision": 17,
                     "job.start": 10, "sched.reserve": 12,
                     "sched.backfill": 12, "job.requeue": 4,
                     "job.finish": 5, "fault.drain": 1,
                     "fault.restore": 1, "job.fail": 1}


# --------------------------------------------------------- rollout extras
def test_collect_yields_transitions_and_eps_schedules_everything():
    _, ta = agent_pair(res("jax"))
    ds, ro = rollout("torch", res("torch"), [synth_jobs(tsim, 0, n=15),
                                             synth_jobs(tsim, 1, n=20)],
                     ta, eps=1.0, seed=3, collect=True)
    trans = list(ro.transitions())
    assert len(trans) == ro.stats.decisions > 0
    width = ds.layout.state_dim + 2 * 2 + ds.layout.window
    for t, i, row, a in trans:
        assert row.shape == (width,) and 0 <= a < ds.layout.window
        assert bool(ro.decided[t, i])
    assert all(r.n_unstarted == 0 for r in ro.results)
    greedy = ds.rollout()
    with pytest.raises(ValueError, match="collect"):
        next(greedy.transitions())


def test_run_traces_device_convenience():
    out = tsim.run_traces_device(res("torch"),
                                 [synth_jobs(tsim, s, n=12) for s in range(2)],
                                 TFCFS(), device="cpu")
    assert len(out) == 2 and all(r.n_unstarted == 0 for r in out)


# ------------------------------------------------------------ protocol gates
def test_device_rejects_host_only_policy():
    assert not supports_device(SlotPolicy())
    assert supports_batch(TFCFS()) and supports_device(TFCFS())
    with pytest.raises(TypeError, match="device stages"):
        tsim.DeviceSimulator(res("torch"), [synth_jobs(tsim, 0, n=5)],
                             SlotPolicy(), device="cpu")


def test_device_rejects_window_mismatch_and_foreign_device():
    _, ta = agent_pair(res("jax"))                  # enc.window == 10
    with pytest.raises(ValueError, match="window"):
        tsim.DeviceSimulator(res("torch"), [synth_jobs(tsim, 0, n=5)], ta,
                             tsim.SimConfig.for_engine("device", window=5),
                             device="cpu")
    with pytest.raises(ValueError, match="lives on cpu"):
        tsim.DeviceSimulator(res("torch"), [synth_jobs(tsim, 0, n=5)], ta,
                             device="meta")


def test_round_budget_error():
    cfg = tsim.SimConfig.for_engine("device", max_rounds=2)
    with pytest.raises(RuntimeError, match="round budget"):
        rollout("torch", res("torch"), [synth_jobs(tsim, 0, n=20)], TFCFS(),
                cfg)


def test_for_engine_device_and_max_rounds():
    cfg = tsim.SimConfig.for_engine("device", window=6, backfill=False,
                                    max_rounds=99)
    assert (cfg.engine, cfg.window, cfg.backfill, cfg.max_rounds) \
        == ("device", 6, False, 99)
    assert "device" in tsim.ENGINES
    with pytest.raises(ValueError, match="max_rounds"):
        tsim.SimConfig.for_engine("device", max_rounds=0)
    with pytest.raises(ValueError, match="engine"):
        tsim.SimConfig.for_engine("gpu_cluster")


def test_fcfs_host_batched_stage():
    """WindowPolicy's select_batch, derived from score_window, picks the
    head of every window, as select does."""
    sim = tsim.Simulator(res("torch"), synth_jobs(tsim, 0, n=30), None)
    ctxs = []
    while (ctx := sim.next_decision()) is not None:
        ctxs.append(ctx)
        sim.post_action(0)
        if len(ctxs) == 6:
            break
    assert list(TFCFS().select_batch(ctxs)) == [0] * 6


# --------------------------------------------------------------- span phases
SPAN_CASES = {"agent-backfill": ("agent", True),
              "agent-no-backfill": ("agent", False),
              "fcfs-backfill": ("fcfs", True)}


@pytest.mark.parametrize("case", list(SPAN_CASES))
def test_span_recorder_phases_cover_every_round(case):
    """``spans=``: one ``round`` span per round run, covered without gaps
    by its phases in order; one ``forward`` per deciding round; a
    ``sync.*`` span per host sync; the same rollout as without spans; and
    nothing recorded into a recorder that is not passed."""
    from repro_torch.core.agent import AgentConfig, MRSchAgent
    from repro_torch.obs import SpanRecorder
    policy, backfill = SPAN_CASES[case]
    pol = (MRSchAgent(res("torch"), AgentConfig(seed=0, **SMALL),
                      device="cpu") if policy == "agent" else TFCFS())
    cfg = tsim.SimConfig.for_engine("device", backfill=backfill)
    rec = SpanRecorder()
    ds = tsim.DeviceSimulator(res("torch"),
                              [synth_jobs(tsim, s, n=25) for s in range(3)],
                              pol, cfg, device="cpu", spans=rec)
    assert rec.counts == {"setup.pack": 1}
    off = ds.rollout()
    assert rec.counts == {"setup.pack": 1}
    on = ds.rollout(spans=rec)
    np.testing.assert_array_equal(on.actions, off.actions)
    np.testing.assert_array_equal(on.decided, off.decided)
    for a, b in zip(off.results, on.results):
        assert_results_equal(a, b)

    st, n = on.stats, rec.counts
    assert n["rollout"] == n["outputs"] == 1
    assert n["round"] == n["advance"] == n["sync.gate"] == n["record"] \
        == st.rounds_run
    assert n["front"] == n["forward"] == n["select"] == st.rounds > 0
    assert n.get("backfill", 0) == (st.rounds if backfill else 0)
    assert n["sync.gate"] + n.get("sync.backfill", 0) == st.host_syncs
    assert (n.get("sync.backfill", 0) > 0) == backfill

    spans = rec.spans()
    kids = {}
    for i, s in enumerate(spans):
        kids.setdefault(s.parent, []).append(i)
    assert [(spans[i].name, spans[i].rollout) for i in kids[-1]] \
        == [("setup.pack", -1), ("rollout", 0)]
    ro = kids[-1][1]
    rounds = [i for i in kids[ro] if spans[i].name == "round"]
    assert [spans[i].name for i in kids[ro]] == ["round"] * len(rounds) \
        + ["outputs"]
    decide = ["front", "forward", "select"] + (["backfill"] if backfill
                                               else [])
    for t, r in enumerate(rounds):
        c = kids[r]
        names = [spans[i].name for i in c]
        assert names in (["advance", "sync.gate", "record"],
                         ["advance", "sync.gate", *decide, "record"])
        assert spans[c[0]].start_ns == spans[r].start_ns
        assert spans[c[-1]].end_ns == spans[r].end_ns
        for a, b in zip(c, c[1:]):
            assert spans[a].end_ns == spans[b].start_ns
        for i in c + sum((kids.get(i, []) for i in c), []):
            assert spans[i].round == t and spans[i].rollout == 0
            assert spans[r].start_ns <= spans[i].start_ns \
                <= spans[i].end_ns <= spans[r].end_ns
        for b in (i for i in c if spans[i].name == "backfill"):
            assert {spans[i].name for i in kids[b]} == {"sync.backfill"}
    assert spans[kids[ro][-1]].round == -1

    ds.rollout(spans=rec)
    assert rec.counts["round"] == 2 * st.rounds_run
    assert {s.rollout for s in rec.spans()} == {-1, 0, 1}
