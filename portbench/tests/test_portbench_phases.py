"""``phases``: the one pass over the profiler's records, a device
operation put down to the innermost span that holds its launch, idle time
split across the spans it overlaps, the phase table, and the six span
metrics' readers, on hand-built spans, device intervals and launch
records whose values are worked out by hand."""
from pathlib import Path
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import harness, phases, yardstick

ROOT = Path(__file__).resolve().parents[2]


class Span:
    def __init__(self, name, start_ns, end_ns, parent, rollout=0, round=-1):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.parent, self.rollout, self.round = parent, rollout, round


# One set-up span; a rollout [100, 200] of two rounds, the first deciding
# with a backfill that syncs once, the second not; the outputs.
SPANS = [Span("setup.pack", 0, 10, -1, -1),                    # 0
         Span("rollout", 100, 200, -1),                        # 1
         Span("round", 110, 150, 1, 0, 0),                     # 2
         Span("advance", 110, 120, 2, 0, 0),                   # 3
         Span("sync.gate", 120, 125, 2, 0, 0),                 # 4
         Span("front", 125, 128, 2, 0, 0),                     # 5
         Span("forward", 128, 140, 2, 0, 0),                   # 6
         Span("select", 140, 143, 2, 0, 0),                    # 7
         Span("backfill", 143, 148, 2, 0, 0),                  # 8
         Span("sync.backfill", 145, 146, 8, 0, 0),             # 9
         Span("record", 148, 150, 2, 0, 0),                    # 10
         Span("round", 150, 180, 1, 0, 1),                     # 11
         Span("advance", 150, 165, 11, 0, 1),                  # 12
         Span("sync.gate", 165, 175, 11, 0, 1),                # 13
         Span("record", 175, 180, 11, 0, 1),                   # 14
         Span("outputs", 185, 195, 1)]                         # 15
# (start, end, name, correlation id, launch start or None)
OPS = [(112, 118, "k_advance", 1, 112),
       (126, 127, "decision_rows_kernel", 2, 126),
       (130, 139, "fused_mlp_fwd_m64_kernel", 3, 129),
       (139, 140, "fused_mlp_fwd_m64_kernel", 4, 128),   # at forward's start
       (141, 143, "k_select", 5, 141),
       (146, 147, "Memcpy DtoH", 6, 145),                  # in sync.backfill
       (105, 106, "fill", 7, 105),                        # rollout's own time
       (190, 192, "Memcpy DtoH", 8, 190),
       (160, 161, "k_orphan", 9, None),                   # no launch record
       (250, 251, "k_outside", 10, 250)]                  # after every span
PHASE = {1: "advance", 2: "front", 3: "forward", 4: "forward", 5: "select",
         6: "sync.backfill", 7: "rollout", 8: "outputs", 9: None, 10: None}


def profile():
    rows = sorted(OPS)
    trace = yardstick.DeviceTrace({}, [r[:3] for r in rows])
    return phases.Profile(trace, [r[3] for r in rows],
                          {r[3]: r[4] for r in rows if r[4] is not None})


class Event:
    def __init__(self, name, start, dur, corr, device=DeviceType.CUDA,
                 annotation=False):
        self._name, self._start, self._dur, self._corr = name, start, dur, corr
        self._device, self._annotation = device, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        return self._corr

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return self._annotation

    def is_hidden_event(self):
        return False


def test_read_profile_is_device_events_plus_launch_records():
    cpu = DeviceType.CPU
    events = [Event("Activity Buffer Request", 1, 5, 7, cpu),
              Event("cudaLaunchKernel", 10, 4, 7, cpu),
              Event("Lazy Function Loading", 11, 2, 7, cpu),
              Event("cudaMemcpyAsync", 30, 9, 8, cpu),
              Event("mrsch.kernel.fused_mlp", 9, 30, 0, cpu, True),
              Event("mrsch.gpu_range", 9, 30, 0, DeviceType.CUDA, True),
              Event("[memory]", 12, 0, 0),
              Event("k2", 40, 3, 8),
              Event("k1", 20, 6, 7),
              Event("k1", 50, 6, 11)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    read = phases.read_profile(prof)
    want = yardstick.device_events(prof)
    assert read.trace.intervals == want.intervals == [
        (20, 26, "k1"), (40, 43, "k2"), (50, 56, "k1")]
    assert {k: (o.count, o.seconds) for k, o in read.trace.ops.items()} \
        == {k: (o.count, o.seconds) for k, o in want.ops.items()}
    assert read.correlation == [7, 8, 11]
    assert read.launches == {7: 10, 8: 30}


def test_a_launch_goes_to_its_innermost_span():
    prof = profile()
    got = [SPANS[i].name if i >= 0 else None
           for i in phases.op_spans(SPANS, prof)]
    want = [PHASE[c] for c in prof.correlation]
    assert got == want
    assert got.count(None) == 2          # no launch record; outside


def test_idle_time_is_split_across_the_spans_it_overlaps():
    idle = phases.idle_by_span(SPANS, profile().trace.intervals)
    assert idle == [10, 19, 0, 4, 5, 2, 2, 1, 3, 1, 2, 0, 14, 10, 5, 8]


def test_phase_table():
    prof = profile()
    ops = [SPANS[i].name if i >= 0 else None
           for i in phases.op_spans(SPANS, prof)]
    rows = phases.phase_table(SPANS, prof.trace.intervals, ops)
    as_tuple = {k: (r.spans, r.host_self_ns, r.device_ns, r.ops, r.idle_ns)
                for k, r in rows.items()}
    assert as_tuple["forward"] == (1, 12, 10, 2, 2)
    assert as_tuple["backfill"] == (1, 4, 0, 0, 3)
    assert as_tuple["round"] == (2, 0, 0, 0, 0)
    assert as_tuple["rollout"] == (1, 20, 1, 1, 19)
    assert as_tuple["advance"] == (2, 25, 6, 1, 18)
    assert as_tuple[None] == (0, 0, 2, 2, 0)
    assert phases.round_cover(SPANS) == 0.0
    gap = list(SPANS)
    gap[14] = Span("record", 175, 177, 11, 0, 1)
    assert phases.round_cover(gap) == pytest.approx(3 / 30)
    lines = phases.table_lines(rows)
    assert lines[0].startswith("phase setup.pack: 1 spans")
    assert lines[-1].startswith("phase (no span): 0 spans")


def context():
    prof = profile()
    ops = [SPANS[i].name if i >= 0 else None
           for i in phases.op_spans(SPANS, prof)]
    return SimpleNamespace(spans=SPANS, op_phase=ops, trace=prof.trace,
                           window_s=100e-9)


@pytest.mark.parametrize("name, value", [
    ("pack_s", 10e-9),
    ("host_issue_ms_per_round", (70 - 16) / 2 / 1e6),
    ("sync_wait_ms_per_round", 16 / 2 / 1e6),
    ("sim_device_ms_per_round", (6 + 1 + 2 + 1) / 2 / 1e6),
    ("forward_device_ms_per_call", 10 / 1e6),
    ("idle_share.round_loop", 100.0 * (18 + 15 + 1 + 1 + 3 + 7) / 100)])
def test_span_metric_readers(name, value):
    read = harness.metric_reader(ROOT, name)
    assert read(context()) == pytest.approx(value)
    # What a run without spans (the parent's program) gives the reader.
    bare = SimpleNamespace(trace=profile().trace, window_s=1.0)
    assert read(bare) is None


@pytest.mark.parametrize("recorded", [False, True])
def test_phase_run_reads_spans_or_refuses(monkeypatch, recorded):
    """``phase_run.wire``'s metric context reads the recorder's spans and
    the launch records of the one profile read; where ``run.py`` went
    round the patched names (no spans, no profile read), it raises."""
    import numpy as np

    from portbench import phase_run, run
    from repro_torch.obs import SpanRecorder
    for mod, name in ((harness, "load_cell"), (harness, "build_sim"),
                      (harness, "timed_rollouts"),
                      (yardstick, "device_events"), (run, "MetricContext")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    rec = SpanRecorder()
    used = phase_run.wire(rec)
    args = (None, None, None, profile().trace, 1.0,
            SimpleNamespace(front=[], qlens=None),
            SimpleNamespace(decided=np.zeros((2, 3), bool)))
    if not recorded:
        with pytest.raises(RuntimeError, match="patches did not take"):
            run.MetricContext(*args)
        assert not used
        return
    rec.open("setup.pack")
    rec.close()
    rec.start_rollout()
    rec.open("rollout", "round", "advance")
    rec.close(3)
    events = [Event("cudaLaunchKernel", 10, 4, 7, DeviceType.CPU),
              Event("k1", 20, 6, 7)]
    trace = yardstick.device_events(SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events))))
    ctx = run.MetricContext(*args[:3], trace, *args[4:])
    assert [s.name for s in ctx.spans] == ["setup.pack", "rollout", "round",
                                           "advance"]
    assert ctx.op_phase == [None]        # launched before every span
    assert used == {"context"}
