"""The port's decision service: micro-batching, buckets, concurrency,
goal overrides, weight swaps; and the whole slice — service-routed replay
in the port against the JAX package's, on the same weights."""
import threading

import numpy as np
import pytest
import torch

from _torch_parity import (PKGS, agent_pair, assert_results_equal,
                           synth_jobs, theta_mini, values_and_margin)
from repro.serve import DecisionService as JService
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServiceSim as JServiceSim
from repro_torch.core import AgentConfig, MRSchAgent
from repro_torch.core.dfp import greedy_action
from repro_torch.core.encoding import encode_measurement, encode_state
from repro_torch.obs import BufferTracer
from repro_torch.serve import (BucketCache, DecisionResponse,
                               DecisionService, MicroBatcher, ServeConfig,
                               ServicePolicy, ServiceSim, bucket_widths)
from repro_torch.sim import ResourceSpec, Simulator

RES = [ResourceSpec("node", 16), ResourceSpec("bb", 8)]


def small_agent(seed: int = 0, backend: str = "kernel") -> MRSchAgent:
    return MRSchAgent(RES, AgentConfig(
        state_hidden=(32, 16), state_out=8, module_hidden=4, seed=seed,
        backend=backend), device="cpu")


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


# ---------------------------------------------------------------- batcher
def test_batcher_results_match_payloads():
    with MicroBatcher(lambda xs: [x * 10 for x in xs], max_batch=4) as mb:
        tickets = [mb.submit(i) for i in range(17)]
        assert [t.result(10.0) for t in tickets] == [i * 10 for i in range(17)]
    st = mb.stats()
    assert st["requests"] == 17
    assert st["max_batch_seen"] <= 4


def test_batcher_error_delivered_to_batch():
    def boom(xs):
        raise RuntimeError("model exploded")
    with MicroBatcher(boom, max_batch=2) as mb:
        t = mb.submit(1)
        with pytest.raises(RuntimeError, match="model exploded"):
            t.result(10.0)


def test_batcher_submit_requires_running():
    mb = MicroBatcher(lambda xs: xs)
    with pytest.raises(RuntimeError, match="not running"):
        mb.submit(1)
    mb.start()
    t = mb.submit(2)
    assert t.result(10.0) == 2
    mb.stop()
    with pytest.raises(RuntimeError, match="not running"):
        mb.submit(3)


def test_batcher_max_wait_coalesces():
    with MicroBatcher(lambda xs: xs, max_batch=8, max_wait_s=0.2) as mb:
        tickets = []

        def client(i):
            tickets.append(mb.submit(i))
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10.0)
        for t in tickets:
            t.result(10.0)
    st = mb.stats()
    assert st["requests"] == 6
    assert st["max_batch_seen"] >= 2


# ---------------------------------------------------------------- buckets
def test_bucket_widths_and_lookup():
    assert bucket_widths(1) == (1,)
    assert bucket_widths(8) == (1, 2, 4, 8)
    assert bucket_widths(12) == (1, 2, 4, 8, 16)
    cache = BucketCache(12)
    assert cache.width_for(1) == 1
    assert cache.width_for(3) == 4
    assert cache.width_for(12) == 16
    with pytest.raises(ValueError):
        cache.width_for(17)
    with pytest.raises(ValueError):
        cache.width_for(0)


def test_bucket_cache_counts_compiles_once():
    cache = BucketCache(4)
    assert cache.record(4) is True
    assert cache.record(4) is False
    st = cache.stats()
    assert (st["compiles"], st["dispatches"], st["bucket_hits"]) == (1, 2, 1)


def test_service_steady_state_never_retraces():
    """After warmup every batch width maps to a bucket already seen."""
    agent = small_agent()
    with DecisionService(agent, ServeConfig(max_batch=8)) as svc:
        n_buckets = len(svc._buckets.widths)
        assert svc.stats()["buckets"]["compiles"] == n_buckets
        ctxs = harvest_contexts(agent)
        for width in (1, 2, 3, len(ctxs)):
            svc.decide_many(ctxs[:width])
        st = svc.stats()["buckets"]
        assert st["compiles"] == n_buckets
        assert st["bucket_hits"] > 0


# ---------------------------------------------------------------- determinism
@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_concurrent_clients_match_agent_select(backend):
    agent = small_agent(backend=backend)
    ctxs = harvest_contexts(agent)
    expected = [agent.select(c) for c in ctxs]
    rows = np.stack([DecisionService(agent)._encode(c) for c in ctxs])
    assert (values_and_margin(agent, rows)[1] > 1e-4).all()
    with DecisionService(agent, ServeConfig(max_batch=8)) as svc:
        results = [None] * len(ctxs)

        def client(i):
            results[i] = svc.decide(ctxs[i])
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(ctxs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
    assert results == expected


def test_select_batch_matches_select():
    agent = small_agent()
    ctxs = harvest_contexts(agent)
    assert agent.select_batch(ctxs).tolist() == [agent.select(c)
                                                 for c in ctxs]


def test_goal_override_matches_direct_scoring():
    agent = small_agent()
    ctxs = harvest_contexts(agent, n_envs=4)
    override = np.asarray([0.9, 0.1], np.float32)
    with DecisionService(agent, ServeConfig(max_batch=4)) as svc:
        got = [svc.decide(c, goal=override) for c in ctxs]
        with pytest.raises(ValueError, match="goal override"):
            svc.decide(ctxs[0], goal=np.ones(3, np.float32))
    expected = []
    for c in ctxs:
        mask = np.zeros(agent.config.window, bool)
        mask[:min(len(c.window), agent.config.window)] = True
        expected.append(int(greedy_action(
            agent.net, agent.dfp,
            torch.from_numpy(encode_state(agent.enc, c)),
            torch.from_numpy(encode_measurement(agent.enc, c)),
            torch.from_numpy(override), torch.from_numpy(mask))))
    assert got == expected


# ---------------------------------------------------------------- the slice
class RecordingPolicy(ServicePolicy):
    """Keeps every served packed row, for the margin check."""

    def __init__(self, service):
        super().__init__(service)
        self.rows = []

    def select(self, ctx):
        self.rows.append(self.service._encode(ctx))
        return super().select(ctx)


def _replay_both(j_res, jobs_j, t_res, jobs_t, seed):
    ja, ta = agent_pair(j_res, seed=seed)
    with JService(ja, JServeConfig(max_batch=8)) as svc:
        ref = JServiceSim(svc, j_res).run_trace(jobs_j)
    with DecisionService(ta, ServeConfig(max_batch=8)) as svc:
        ssim = ServiceSim(svc, t_res)
        ssim.policy = RecordingPolicy(svc)
        got = ssim.run_trace(jobs_t)
    u, margin = values_and_margin(ta, np.stack(ssim.policy.rows))
    # Rows with two or more valid slots: their top-2 margin is above the
    # float32 tolerance, so the packages may not diverge anywhere.
    contested = np.isfinite(margin)
    tol = 2e-4 * max(1.0, float(np.abs(u[np.isfinite(u)]).max()))
    return ref, got, margin[contested], tol


def test_replay_matches_reference_on_synth_jobs():
    jsim, tsim = PKGS["jax"], PKGS["torch"]
    j_res = [jsim.ResourceSpec("node", 16), jsim.ResourceSpec("bb", 8)]
    ref, got, margin, tol = _replay_both(
        j_res, synth_jobs(jsim, 3), RES, synth_jobs(tsim, 3), seed=0)
    assert got.decisions > 40 and margin.size > 20
    assert margin.min() > tol
    assert_results_equal(got, ref)


def test_replay_matches_reference_on_mini_s1():
    (j_res, jobs_j), (t_res, jobs_t) = (theta_mini("jax", "S1", days=0.3),
                                        theta_mini("torch", "S1", days=0.3))
    ref, got, margin, tol = _replay_both(j_res, jobs_j, t_res, jobs_t, seed=0)
    assert got.decisions > 0
    assert margin.size == 0 or margin.min() > tol
    assert_results_equal(got, ref)


def test_service_sim_tracks_latency():
    agent = small_agent()
    with DecisionService(agent, ServeConfig(max_batch=4)) as svc:
        ssim = ServiceSim(svc, RES, track_latency=True)
        result = ssim.run_trace(synth_jobs(PKGS["torch"], 1, n=15))
    assert len(ssim.latencies_s) == result.decisions
    assert all(t > 0 for t in ssim.latencies_s)


# ---------------------------------------------------------------- weight swap
def test_update_params_swaps_between_requests():
    agent_a, agent_b = small_agent(seed=0), small_agent(seed=13)
    ctxs = harvest_contexts(agent_a)
    expected_a = [agent_a.select(c) for c in ctxs]
    expected_b = [agent_b.select(c) for c in ctxs]
    assert expected_a != expected_b
    tracer = BufferTracer()
    with DecisionService(agent_a, ServeConfig(max_batch=8),
                         tracer=tracer) as svc:
        before = [svc.decide(c) for c in ctxs]
        svc.update_params(agent_b.net, step=5)
        assert svc.params_step == 5 and svc.params is agent_b.net
        after = [svc.decide(c) for c in ctxs]
    assert (before, after) == (expected_a, expected_b)
    assert svc.stats()["reloads"] == 1
    dispatches = [e for e in tracer.events if e["ev"] == "serve.dispatch"]
    assert dispatches and all(e["env"] == -1 and e["width"] >= e["n"]
                              for e in dispatches)
    assert [e["step"] for e in tracer.events
            if e["ev"] == "ckpt.reload"] == [5]


def test_update_params_rejects_incompatible_network():
    agent = small_agent()
    wrong = MRSchAgent(RES, AgentConfig(state_hidden=(16, 8), state_out=8,
                                        module_hidden=4), device="cpu")
    ctxs = harvest_contexts(agent, n_envs=4)
    expected = [agent.select(c) for c in ctxs]
    with DecisionService(agent, ServeConfig(max_batch=4)) as svc:
        with pytest.raises(ValueError, match="mismatch"):
            svc.update_params(wrong.net)
        with pytest.raises(ValueError, match="DFPNetwork"):
            svc.update_params({"not": "a network"})
        assert [svc.decide(c) for c in ctxs] == expected
    assert svc.stats()["reloads"] == 0


# ---------------------------------------------------------------- telemetry
def test_decide_many_rejects_mismatched_goals():
    agent = small_agent()
    ctxs = harvest_contexts(agent, n_envs=4)
    with DecisionService(agent, ServeConfig(max_batch=4)) as svc:
        with pytest.raises(ValueError, match="decide_many"):
            svc.decide_many(ctxs, goals=[None] * (len(ctxs) - 1))


def test_decide_full_carries_per_request_telemetry():
    agent = small_agent()
    ctxs = harvest_contexts(agent, n_envs=4)
    with DecisionService(agent, ServeConfig(max_batch=4)) as svc:
        plain = [svc.decide(c) for c in ctxs]
        full = [svc.decide_full(c) for c in ctxs]
        ticket = svc.submit(ctxs[0])
        ticket.result(10.0)
    assert set(ticket.meta) == {"queue_wait_s", "batch_size"}
    widths = set(bucket_widths(4))
    for resp, action in zip(full, plain):
        assert isinstance(resp, DecisionResponse)
        assert resp.action == action
        assert resp.queue_wait_s >= 0.0
        assert 1 <= resp.batch_size <= 4 and resp.width in widths
