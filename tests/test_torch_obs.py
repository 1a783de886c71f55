"""The port's telemetry layer (``repro_torch.obs``) against the JAX
package's (tests/test_obs.py): the metrics registry's snapshot and
Prometheus text, the JSONL flusher, trace files byte for byte in both
directions and their Chrome export, ``tools/trace_report.py`` on a
port-written trace, ``span``, the profiler scopes, and the vectorised
trainer's registry on the same weights."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as tobs
from _torch_parity import PKGS, agent_pair, synth_jobs
from repro.core import EnvSlot as JEnvSlot
from repro.core import TrainConfig as JTrainConfig
from repro.core import train_agent_vectorized as jtrain_vectorized
from repro_torch.core import (EnvSlot, FCFSPolicy, TrainConfig, train_agent,
                              train_agent_vectorized)
from repro_torch.sim import ResourceSpec

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
OBS = {"jax": jobs, "torch": tobs}


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


trace_report = _load("trace_report", "tools/trace_report.py")


# ------------------------------------------------------------- metrics
def fill_registry(obs, prefix):
    """tests/test_obs.py's calls and then some, on ``obs``'s registry."""
    reg = obs.MetricsRegistry(prefix=prefix)
    reg.counter("serve_requests_total").inc(3)
    reg.counter("serve_requests_total").inc()
    with pytest.raises(ValueError, match="only go up"):
        reg.counter("serve_requests_total").inc(-1)
    reg.counter("serve_batch_rows_total", {"width": 4}).inc(3)
    reg.counter("serve_batch_rows_total", {"width": 16}).inc(13)
    reg.gauge("train_loss").set(0.25)
    reg.gauge("train_loss", labels={"lane": "a"}).set(0.5)
    reg.gauge("train_loss", labels={"lane": "lane-b", "z": 1}).inc(2.5)
    reg.gauge("serve_queue_depth").set(np.int64(7))
    h = reg.histogram("serve_queue_wait_seconds")
    for v in (0.002, 0.02, 0.2, 1e-7, 31.0):
        h.observe(v)
    reg.histogram("serve_batch_size", buckets=(1, 2, 4, 8, 16)).observe(3)
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("serve_requests_total")
    return reg


@pytest.mark.parametrize("prefix", ["mrsch", ""])
def test_registry_matches_reference(prefix):
    regs = {pkg: fill_registry(OBS[pkg], prefix) for pkg in OBS}
    assert regs["torch"].snapshot() == regs["jax"].snapshot()
    assert json.dumps(regs["torch"].snapshot(), sort_keys=True) == \
        json.dumps(regs["jax"].snapshot(), sort_keys=True)
    text = regs["torch"].to_prometheus()
    assert text == regs["jax"].to_prometheus()
    snap = regs["torch"].snapshot()
    assert snap["train_loss"]['{lane="a"}'] == 0.5
    assert snap["serve_batch_rows_total"]['{width="16"}'] == 13.0
    full = f"{prefix}_" if prefix else ""
    assert f"# TYPE {full}serve_requests_total counter" in text
    assert f'{full}serve_queue_wait_seconds_bucket{{le="+Inf"}} 5' in text


def test_jsonl_flusher_appends_snapshots(tmp_path):
    reg = tobs.MetricsRegistry()
    reg.counter("train_episodes_total").inc()
    fl = tobs.JsonlFlusher(reg, tmp_path / "m" / "metrics.jsonl",
                           interval_s=3600)
    fl.flush()
    reg.counter("train_episodes_total").inc()
    with fl:                         # start/stop does a final flush
        pass
    lines = [json.loads(ln) for ln in
             (tmp_path / "m" / "metrics.jsonl").read_text().splitlines()]
    assert len(lines) == 2
    assert lines[0]["metrics"]["train_episodes_total"][""] == 1.0
    assert lines[1]["metrics"]["train_episodes_total"][""] == 2.0
    assert all("ts" in ln for ln in lines)
    assert lines[1]["metrics"] == reg.snapshot()


# ---------------------------------------------------------- trace files
def record(obs):
    tr = obs.BufferTracer()
    tr.meta["envs"] = {"0": {"policy": "FCFS", "scenario": "S1", "seed": 1}}
    tr.span("warmup", 0.5)
    tr.job_queued(1, 5.0, 7)
    tr.job_queued(0, 1.0, 1)
    tr.job_start(0, 2.0, 1)
    tr.decision(0, 2.0, 0, 1, 3, 1)
    tr.job_finish(0, 3.5, 1)
    tr.job_start(0, 2.25, 2, bf=1)    # still running at trace end
    tr.job_requeue(1, 6.1, 7, 1)
    tr.drain(0, 0.3, "node", 4)
    tr.restore(0, 0.7, "node", 4)
    tr.dispatch(4, 8, 0.001234567)
    tr.ckpt_reload(3)
    # Host events carry wall time: pin them so both packages agree.
    for e in tr.events:
        if e["env"] == -1:
            e["t"] = 1.5
    return tr


def test_trace_files_match_reference(tmp_path):
    trs = {pkg: record(OBS[pkg]) for pkg in OBS}
    assert trs["torch"].events == trs["jax"].events
    lines = {pkg: OBS[pkg].trace_lines(trs[pkg].events, trs[pkg].meta)
             for pkg in OBS}
    assert lines["torch"] == lines["jax"]
    paths = {pkg: OBS[pkg].write_trace(trs[pkg].events,
                                       tmp_path / pkg / "t.jsonl",
                                       meta=trs[pkg].meta) for pkg in OBS}
    assert paths["torch"].read_bytes() == paths["jax"].read_bytes()
    for reader in OBS:                # each package reads both files
        for writer in OBS:
            meta, events = OBS[reader].read_trace(paths[writer])
            assert meta == trs["torch"].meta
            assert events == tobs.canonical_events(trs["torch"].events)
    assert tobs.to_chrome(trs["torch"].events, meta={"k": "v"}) == \
        jobs.to_chrome(trs["jax"].events, meta={"k": "v"})
    chrome = tobs.to_chrome(trs["torch"].events)
    byname = {s["name"]: s for s in chrome["traceEvents"] if s["ph"] == "X"}
    assert byname["job 1"]["dur"] == pytest.approx(1.5e6)
    assert byname["job 2"]["args"] == {"backfilled": 1,
                                       "outcome": "running"}
    assert byname["warmup"]["pid"] == -1


def test_read_trace_validates_the_header(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"schema":"mrsch.trace/v999"}\n')
    with pytest.raises(ValueError, match="mrsch.trace/v1"):
        tobs.read_trace(bad)
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    with pytest.raises(ValueError, match="empty"):
        tobs.read_trace(empty)
    assert tobs.NullTracer is tobs.Tracer and not tobs.NULL.enabled


def test_trace_report_reads_a_port_trace(tmp_path):
    """A trace the port's lockstep engine wrote goes through
    tools/trace_report.py (which reads it with the JAX package)."""
    tr = tobs.BufferTracer()
    res = [ResourceSpec("node", 16), ResourceSpec("bb", 8)]
    sim = PKGS["torch"]
    jobsets = [synth_jobs(sim, s, n=20) for s in range(2)]
    with tobs.span(tr, "policy:FCFS"):
        sim.VectorSimulator.from_jobsets(res, jobsets, FCFSPolicy(),
                                         tracer=tr).run()
    tr.meta["envs"] = {str(i): {"policy": "FCFS", "scenario": "synth",
                                "seed": i} for i in range(2)}
    path = tobs.write_trace(tr.events, tmp_path / "port.jsonl", meta=tr.meta)
    meta, events = trace_report.read_trace(path)
    report = trace_report.build_report(meta, events)
    assert report["schema"] == "mrsch.trace/v1"
    assert report["n_events"] == len(events) > 0
    decisions = sum(1 for e in events if e["ev"] == "sched.decision")
    assert report["counts"]["sched.decision"] == decisions > 0
    assert "policy:FCFS" in report["spans"]
    assert report["policies"]["FCFS"]["decisions"] == decisions


# ------------------------------------------------------------ profiling
def test_span_emits_prof_span():
    tr = tobs.BufferTracer()
    with tobs.span(tr, "phase"):
        pass
    with pytest.raises(KeyError):
        with tobs.span(tr, "failing"):
            raise KeyError("x")       # the span still closes
    names = [(e["ev"], e["env"], e["name"]) for e in tr.events]
    assert names == [("prof.span", -1, "phase"), ("prof.span", -1, "failing")]
    assert all(e["dur_s"] >= 0.0 for e in tr.events)
    with tobs.span(tobs.NULL, "free"):
        pass
    with tobs.span(None, "free"):
        pass


def profiled_names(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


def test_profiler_scopes_keep_their_names():
    """``annotate``/``named_scope``/``span`` open profiler ranges by name;
    the device rollout's and the lockstep engine's scopes show in a
    capture of a CPU run."""
    def scopes():
        with tobs.annotate("mrsch.a"), tobs.named_scope("mrsch.kernel.b"):
            torch.ones(2).sum()
        with tobs.span(tobs.NULL, "c"):
            pass
    assert {"mrsch.a", "mrsch.kernel.b", "mrsch.c"} <= profiled_names(scopes)
    res = [ResourceSpec("node", 16), ResourceSpec("bb", 8)]
    sim = PKGS["torch"]
    jobsets = [synth_jobs(sim, s, n=10) for s in range(2)]
    names = profiled_names(lambda: (
        sim.run_traces_device(res, jobsets, FCFSPolicy(), device="cpu"),
        sim.run_traces(res, jobsets, FCFSPolicy())))
    assert {"mrsch.device.rollout", "mrsch.vector.policy_select"} <= names


def test_profiler_ranges_are_a_shared_no_op_when_no_profiler_runs():
    """With no profiler enabled, ``annotate`` and ``named_scope`` return
    one shared no-op context; under a profiler, a ``record_function``
    range."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import profiling
    assert tobs.annotate("mrsch.a") is profiling.NO_RANGE
    assert tobs.named_scope("mrsch.kernel.b") is profiling.NO_RANGE
    with profile(activities=[ProfilerActivity.CPU]):
        for scope in (tobs.annotate("mrsch.a"),
                      tobs.named_scope("mrsch.kernel.b")):
            assert scope is not profiling.NO_RANGE
            with scope:
                pass
    assert tobs.named_scope("mrsch.kernel.b") is profiling.NO_RANGE


def test_span_recorder_nests_and_reads_the_profilers_clock():
    """Spans nest by ``open``/``next``/``close``, count by name, give self
    times, and lie on the profiler's clock: a span opened before a
    ``record_function`` range and closed after it holds the range's
    record."""
    from torch.profiler import ProfilerActivity, profile
    rec = tobs.SpanRecorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec.open("outer", "a")
        rec.next("b")
        with torch.profiler.record_function("probe"):
            torch.ones(8).sum()
        rec.open("c")
        rec.close(3)
    spans = rec.spans()
    assert [(s.name, s.parent, s.rollout, s.round) for s in spans] == [
        ("outer", -1, -1, -1), ("a", 0, -1, -1), ("b", 0, -1, -1),
        ("c", 2, -1, -1)]
    outer, a, b, c = spans
    assert outer.start_ns == a.start_ns and a.end_ns == b.start_ns
    assert c.end_ns == b.end_ns == outer.end_ns
    assert rec.counts == {"outer": 1, "a": 1, "b": 1, "c": 1}
    summary = tobs.span_summary(spans)
    assert summary["outer"] == (1, outer.end_ns - outer.start_ns, 0)
    assert summary["b"][2] == (b.end_ns - b.start_ns) - (c.end_ns - c.start_ns)
    probe = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "probe"]
    assert len(probe) == 1
    assert b.start_ns <= probe[0].start_ns() <= probe[0].end_ns() <= c.start_ns
    assert rec.start_rollout() == 0
    rec.round = 4
    rec.open("round")
    rec.close()
    assert rec.spans()[-1][3:] == (-1, 0, 4)


def test_no_raw_profiler_ranges_left_in_the_package():
    """Every ``mrsch.*`` scope goes through ``repro_torch.obs.profiling``;
    no module but that one opens a ``record_function`` itself."""
    raw = [str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
           if "record_function(" in p.read_text()
           and p != PORT / "obs" / "profiling.py"]
    assert raw == []
    scopes = set()
    for p in PORT.rglob("*.py"):
        for fn in ("named_scope", "annotate"):
            for part in p.read_text().split(f'{fn}("mrsch.')[1:]:
                scopes.add("mrsch." + part.split('"')[0])
    assert {"mrsch.kernel.fused_mlp", "mrsch.kernel.fused_mlp_bwd",
            "mrsch.kernel.window_pack", "mrsch.kernel.mha_fwd",
            "mrsch.kernel.mha_bwd", "mrsch.kernel.flash_attention",
            "mrsch.kernel.ssd", "mrsch.device.rollout",
            "mrsch.vector.policy_select", "mrsch.train.episode_flush",
            "mrsch.train.grad_steps", "mrsch.lm.block", "mrsch.lm.attention",
            "mrsch.lm.logits_ce", "mrsch.lm.adamw"} == scopes


# ----------------------------------------------------- train registry
TRAIN = dict(stream_hidden=16, batch_size=16, grad_steps_per_episode=4,
             eps_decay=0.9)


def trainer_lanes(pkg):
    sim, slot = (PKGS["jax"], JEnvSlot) if pkg == "jax" else \
        (PKGS["torch"], EnvSlot)
    res = [sim.ResourceSpec("node", 16), sim.ResourceSpec("bb", 8)]
    return [slot(jobsets=[("a", synth_jobs(sim, 1, n=40))], resources=res,
                 tag="lane-a"),
            slot(jobsets=[("b", synth_jobs(sim, 2, n=30)),
                          ("c", synth_jobs(sim, 3, n=20))], resources=res,
                 tag="lane-b")]


def test_vectorized_trainer_fills_registry_like_reference():
    """On the same converted weights, both packages' vectorised trainers
    fill the same metric names and labels, with equal episode and
    decision totals, equal epsilon and losses within rtol 1e-4."""
    res = [ResourceSpec("node", 16), ResourceSpec("bb", 8)]
    ja, ta = agent_pair(res, **TRAIN)
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jlog = jtrain_vectorized(ja, trainer_lanes("jax"), JTrainConfig(n_envs=2),
                             registry=jreg)
    log = train_agent_vectorized(ta, trainer_lanes("torch"),
                                 TrainConfig(n_envs=2), registry=treg)
    js, ts = jreg.snapshot(), treg.snapshot()
    assert sorted(ts) == sorted(js) == [
        "train_decisions_per_sec", "train_decisions_total",
        "train_episode_loss", "train_episodes_total", "train_epsilon",
        "train_grad_norm", "train_loss"]
    for name in js:
        assert sorted(ts[name]) == sorted(js[name]), name
    assert ts["train_episodes_total"] == js["train_episodes_total"] == {
        '{lane="lane-a"}': 1.0, '{lane="lane-b"}': 2.0}
    assert ts["train_decisions_total"] == js["train_decisions_total"]
    assert sum(ts["train_decisions_total"].values()) == log.decisions \
        == jlog.decisions
    assert ts["train_epsilon"] == js["train_epsilon"]
    assert ts["train_episode_loss"][""]["count"] == \
        js["train_episode_loss"][""]["count"] == len(log.episode_losses)
    np.testing.assert_allclose(ts["train_loss"][""], js["train_loss"][""],
                               rtol=1e-4)
    np.testing.assert_allclose(ts["train_grad_norm"][""],
                               js["train_grad_norm"][""], rtol=1e-3)
    assert ts["train_decisions_per_sec"][""] > 0.0


def test_train_agent_passes_the_registry_on():
    """``train_agent`` with a ``TrainConfig`` hands its registry to the
    vectorised trainer; the sequential loop, as the JAX package's, fills
    none."""
    res = [ResourceSpec("node", 16), ResourceSpec("bb", 8)]
    jobsets = [synth_jobs(PKGS["torch"], s, n=20) for s in range(3)]
    _, ta = agent_pair(res, **TRAIN)
    reg = tobs.MetricsRegistry()
    log = train_agent(ta, res, jobsets, config=TrainConfig(n_envs=2),
                      registry=reg)
    snap = reg.snapshot()
    assert snap["train_episodes_total"] == {'{lane="env0"}': 2.0,
                                            '{lane="env1"}': 1.0}
    assert sum(snap["train_decisions_total"].values()) == log.decisions
    _, tb = agent_pair(res, **TRAIN)
    seq = tobs.MetricsRegistry()
    train_agent(tb, res, jobsets[:1], registry=seq)
    assert seq.snapshot() == {}
