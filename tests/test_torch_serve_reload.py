"""Hot reload of the port's decision service (``repro_torch.serve.
CheckpointWatcher``) and its telemetry wiring, after tests/test_serve.py:
swaps mid-stream and under concurrent clients, foreign and stale
checkpoints, stray directory entries, the metrics registry and tracer;
and a checkpoint step written by the JAX package swapped into the port's
service."""
import threading

import numpy as np
import pytest

from _torch_parity import PKGS, agent_pair, synth_jobs
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.serve import DecisionService as JService
from repro.serve import ServeConfig as JServeConfig
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import AgentConfig, MRSchAgent
from repro_torch.obs import BufferTracer, MetricsRegistry
from repro_torch.serve import CheckpointWatcher, DecisionService, ServeConfig
from repro_torch.sim import ResourceSpec, Simulator

RES = [ResourceSpec("node", 16), ResourceSpec("bb", 8)]


def small_agent(seed: int = 0, **kw) -> MRSchAgent:
    cfg = dict(state_hidden=(32, 16), state_out=8, module_hidden=4)
    return MRSchAgent(RES, AgentConfig(seed=seed, **{**cfg, **kw}),
                      device="cpu")


def harvest_contexts(agent, n_envs: int = 6, depth: int = 5):
    """Frozen mid-trace contexts (tests/test_serve.py's helper)."""
    ctxs = []
    for s in range(n_envs):
        sim = Simulator(RES, synth_jobs(PKGS["torch"], s), agent)
        ctx = sim.next_decision()
        for _ in range(depth):
            if ctx is None:
                break
            sim.post_action(agent.select(ctx))
            ctx = sim.next_decision()
        if ctx is not None:
            ctxs.append(ctx)
    assert len(ctxs) >= 4
    return ctxs


def test_hot_reload_mid_stream(tmp_path):
    """Requests answered before the swap see the old weights, requests
    after it the new ones, and none is dropped."""
    agent_a, agent_b = small_agent(seed=0), small_agent(seed=13)
    ctxs = harvest_contexts(agent_a)
    expected_a = [agent_a.select(c) for c in ctxs]
    expected_b = [agent_b.select(c) for c in ctxs]
    assert expected_a != expected_b           # the swap is observable
    mgr = CheckpointManager(str(tmp_path))
    with DecisionService(agent_a, ServeConfig(max_batch=8)) as svc:
        watcher = CheckpointWatcher(svc, str(tmp_path))
        before = [svc.decide(c) for c in ctxs]
        mgr.save(agent_b.net, step=5)
        assert watcher.check_once() == 5
        assert svc.params_step == 5
        assert svc.params is not agent_b.net  # a restored copy
        after = [svc.decide(c) for c in ctxs]
    assert before == expected_a
    assert after == expected_b
    assert svc.stats()["reloads"] == 1
    assert watcher.stats() == {"loaded_step": 5, "rejected": 0,
                               "transient_errors": 0}


def test_hot_reload_with_concurrent_clients(tmp_path):
    """The watcher's thread swaps weights while clients submit: every
    answer is the greedy action under the old or the new weights, and
    every client's first request after the swap is answered on the new
    ones."""
    agent_a, agent_b = small_agent(seed=0), small_agent(seed=13)
    ctxs = harvest_contexts(agent_a)
    expected_a = [agent_a.select(c) for c in ctxs]
    expected_b = [agent_b.select(c) for c in ctxs]
    rounds = 30
    with DecisionService(agent_a, ServeConfig(max_batch=8)) as svc:
        results = [[None] * rounds for _ in ctxs]
        finals = [None] * len(ctxs)
        swapped = threading.Event()

        def client(i):
            for r in range(rounds):       # overlaps the swap below
                results[i][r] = svc.decide(ctxs[i])
            swapped.wait()                # then one strictly-post-swap round
            finals[i] = svc.decide(ctxs[i])
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(ctxs))]
        for t in threads:
            t.start()
        CheckpointManager(str(tmp_path)).save(agent_b.net, step=1)
        with CheckpointWatcher(svc, str(tmp_path), poll_interval_s=0.01):
            while svc.params_step != 1:
                threading.Event().wait(0.01)
        swapped.set()
        for t in threads:
            t.join()
    for i in range(len(ctxs)):
        valid = {expected_a[i], expected_b[i]}
        assert all(r in valid for r in results[i])
        assert finals[i] == expected_b[i]     # post-swap settles on B
    st = svc.stats()
    assert st["reloads"] == 1 and st["requests"] >= rounds * len(ctxs)


def test_update_params_rejects_incompatible_tree():
    agent = small_agent()
    attn = small_agent(state_module="attention", queue_cap=12, attn_dim=8,
                       attn_heads=2, attn_layers=2)
    ctxs = harvest_contexts(agent, n_envs=4)
    expected = [agent.select(c) for c in ctxs]
    with DecisionService(agent, ServeConfig(max_batch=4)) as svc:
        with pytest.raises(ValueError, match="incompatible parameter names"):
            svc.update_params(attn.net)
        with pytest.raises(ValueError, match="shape mismatch"):
            svc.update_params(small_agent(state_hidden=(16, 8)).net)
        with pytest.raises(ValueError, match="dtype mismatch"):
            svc.update_params(small_agent().net.double())
        assert [svc.decide(c) for c in ctxs] == expected
    assert svc.stats()["reloads"] == 0


def test_watcher_skips_stale_and_rejects_foreign(tmp_path):
    agent, other = small_agent(), small_agent(seed=3)
    wrong = small_agent(state_hidden=(16, 8))
    mgr = CheckpointManager(str(tmp_path), keep=5)
    with DecisionService(agent, ServeConfig(max_batch=4,
                                            warmup=False)) as svc:
        watcher = CheckpointWatcher(svc, str(tmp_path))
        assert watcher.check_once() is None   # empty directory
        mgr.save(agent.net, step=1)
        mgr.save(other.net, step=2)
        assert watcher.check_once() == 2      # straight to the newest
        assert watcher.check_once() is None   # already current
        mgr.save(wrong.net, step=3)           # foreign architecture
        assert watcher.check_once() is None
        st = watcher.stats()
        assert st["rejected"] == 1
        assert st["loaded_step"] == 3         # not retried until newer
        assert watcher.check_once() is None and \
            watcher.stats()["rejected"] == 1
        mgr.save(other.net, step=4)
        assert watcher.check_once() == 4      # recovers on the next good one
    assert svc.stats()["reloads"] == 2


def test_watcher_survives_stray_directory_entries(tmp_path):
    """A non-checkpoint step_* entry (an operator's backup copy) neither
    kills the watcher nor hides real checkpoints behind it."""
    agent, other = small_agent(), small_agent(seed=3)
    (tmp_path / "step_backup").mkdir()
    (tmp_path / "step_00000009.tmp").mkdir()  # a save in flight
    with DecisionService(agent, ServeConfig(max_batch=4,
                                            warmup=False)) as svc:
        watcher = CheckpointWatcher(svc, str(tmp_path))
        assert watcher.check_once() is None   # stray entries alone: no-op
        CheckpointManager(str(tmp_path)).save(other.net, step=7)
        assert watcher.check_once() == 7      # real checkpoint still found
    assert svc.params_step == 7


def test_service_registry_and_tracer_wiring():
    """The service fills its registry with the JAX package's names and
    emits serve.dispatch / ckpt.reload events."""
    agent, other = small_agent(), small_agent(seed=3)
    ctxs = harvest_contexts(agent, n_envs=4)
    reg, tracer = MetricsRegistry(), BufferTracer()
    with DecisionService(agent, ServeConfig(max_batch=4),
                         registry=reg, tracer=tracer) as svc:
        for c in ctxs:
            svc.decide(c)
        svc.decide_many(ctxs)
        svc.update_params(other.net, step=5)
    snap = reg.snapshot()
    stats = svc.stats()
    assert snap["serve_requests_total"][""] == 2 * len(ctxs) \
        == stats["requests"]
    assert snap["serve_batches_total"][""] == stats["batches"]
    assert snap["serve_reloads_total"][""] == 1.0
    rows = snap["serve_batch_rows_total"]
    assert set(rows) <= {f'{{width="{w}"}}' for w in (1, 2, 4)}
    assert sum(rows.values()) == 2 * len(ctxs)
    assert 0.0 <= snap["serve_bucket_hit_rate"][""] <= 1.0
    assert snap["serve_queue_wait_seconds"][""]["count"] == 2 * len(ctxs)
    assert snap["serve_batch_size"][""]["count"] == stats["batches"]
    assert "serve_queue_depth" in snap

    dispatches = [e for e in tracer.events if e["ev"] == "serve.dispatch"]
    assert len(dispatches) == stats["batches"]
    assert all(e["env"] == -1 and e["wait_s"] >= 0.0 and e["width"] >= e["n"]
               for e in dispatches)
    assert [e["step"] for e in tracer.events
            if e["ev"] == "ckpt.reload"] == [5]


def test_service_registry_keys_match_reference():
    """Both services, one request at a time over the same contexts on the
    same weights, leave registries with the same metric names, labels and
    counts."""
    ja, ta = agent_pair(RES)
    jb, tb = agent_pair(RES, seed=3)
    snaps = {}
    for pkg, (a, b, svc_cls, cfg_cls, reg_cls) in {
            "jax": (ja, jb, JService, JServeConfig, JMetricsRegistry),
            "torch": (ta, tb, DecisionService, ServeConfig,
                      MetricsRegistry)}.items():
        sim = PKGS[pkg]
        ctxs = []
        for s in range(3):
            simu = sim.Simulator(
                [sim.ResourceSpec("node", 16), sim.ResourceSpec("bb", 8)],
                synth_jobs(sim, s), None)
            ctxs.append(simu.next_decision())
        reg = reg_cls()
        with svc_cls(a, cfg_cls(max_batch=4), registry=reg) as svc:
            for c in ctxs:
                svc.decide(c)
            svc.update_params(b.params if pkg == "jax" else b.net, step=2)
        snaps[pkg] = reg.snapshot()
    counts = ("serve_requests_total", "serve_batches_total",
              "serve_batch_rows_total", "serve_reloads_total",
              "serve_bucket_hit_rate")
    assert sorted(snaps["torch"]) == sorted(snaps["jax"])
    for name in snaps["jax"]:
        assert sorted(snaps["torch"][name]) == sorted(snaps["jax"][name])
    for name in counts:
        assert snaps["torch"][name] == snaps["jax"][name], name
    for name in ("serve_batch_size", "serve_queue_wait_seconds"):
        assert snaps["torch"][name][""]["count"] == \
            snaps["jax"][name][""]["count"]


def test_reference_checkpoint_is_hot_swapped_into_the_port(tmp_path):
    """The JAX package's ``CheckpointManager.save`` writes agent B's
    weights; the port's watcher swaps that step into a service serving
    agent A, which then answers with B's greedy decisions."""
    ja, ta = agent_pair(RES, seed=0)
    jb, tb = agent_pair(RES, seed=13)
    ctxs = harvest_contexts(ta)
    expected_a = [ta.select(c) for c in ctxs]
    expected_b = [tb.select(c) for c in ctxs]
    assert expected_a != expected_b
    tracer = BufferTracer()
    with DecisionService(ta, ServeConfig(max_batch=8),
                         tracer=tracer) as svc:
        watcher = CheckpointWatcher(svc, str(tmp_path))
        before = svc.decide_many(ctxs).tolist()
        JCheckpointManager(str(tmp_path)).save(jb.params, step=11)
        assert watcher.check_once() == 11
        after = svc.decide_many(ctxs).tolist()
    assert (before, after) == (expected_a, expected_b)
    assert svc.stats()["reloads"] == 1
    assert watcher.stats()["rejected"] == 0
    assert [e["step"] for e in tracer.events
            if e["ev"] == "ckpt.reload"] == [11]
