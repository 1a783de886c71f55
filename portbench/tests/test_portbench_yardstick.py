"""The operation and byte counts of B1, B4 and B5 on hand-computed shapes,
``mfu.sweep``'s arithmetic and the trace reductions."""
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, yardstick

ROOT = Path(__file__).resolve().parents[2]
MLP = json.loads((ROOT / "portbench/configs/mrsch-mlp-theta.json")
                 .read_text())
ATTN = json.loads((ROOT / "portbench/configs/mrsch-attn-theta.json")
                  .read_text())


def test_layer_cost_by_hand():
    nbytes, flops = yardstick.layer_cost(2, 3, 5)
    assert nbytes == 4 * (2 * 3 + 3 * 5 + 5 + 2 * 5)
    assert flops == 2 * 2 * 3 * 5
    big = yardstick.bound_s(*yardstick.layer_cost(2048, 11410, 4000))
    assert big == pytest.approx(2 * 2048 * 11410 * 4000 / 495e12)


def test_forward_layers():
    mlp = yardstick.forward_layers(MLP, 64)
    assert len(mlp) == 13
    assert mlp[0] == (64, 11410, 4000) and mlp[2] == (64, 1000, 512)
    assert mlp[-1] == (64, 512, 10 * 6 * 2)
    attn = yardstick.forward_layers(ATTN, 8)
    assert len(attn) == 25
    assert attn[0] == (8 * 128, 4, 64) and attn[1] == (8, 4, 64)
    assert attn[2] == (8 * 129, 64, 64) and attn[6] == (8 * 129, 64, 128)
    assert attn[14] == (8, 64 * 12, 512)


def test_front_cost_by_hand():
    call = yardstick.FrontCall(n=2, j=3, waiting=2, running=1, in_goal=3,
                               selected=2)
    R, U, K, row = 2, 5, 4, 7
    nbytes, ops = yardstick.front_cost(call, R, U, K, row)
    read = 2 * (3 * 7 + 4 + 4 * 5) + 4 * 2 + 4 * 2 + 4 * 1 + 4 * 2 * 3 \
        + 4 * 4 * 2
    written = 2 * (4 * 3 + 4 + 4 * 2 + 4 * 4 + 4 + 4 * 7)
    assert nbytes == read + written
    assert ops == 2 * 3 * 4 + 6 * 2 * 5 + 2 * 2 + (3 + 4) * 3


def test_mha_cost_by_hand():
    # 2 batch-heads, 3 queries, head width 4, 5 kept keys in all
    nbytes, flops = yardstick.mha_cost(5, 2, 3, 4)
    assert nbytes == 4 * (6 * 4 + (2 * 5 * 4 + 2) + 6 * 4 + 6)
    assert flops == 2 * 2 * 3 * 5 * 4


def test_decision_flops():
    heads = (2 * (2 * 128 + 128 * 128 * 2) * 2
             + 2 * (768 * 512 + 512 * 120) + 2 * (768 * 512 + 512 * 12))
    state = 2 * (11410 * 4000 + 4000 * 1000 + 1000 * 512)
    assert yardstick.decision_flops(MLP) == state + heads
    d, L = 64, 3
    enc = (2 * (L * 4 * d + 4 * d)
           + 2 * (2 * (L + 1) * (4 * d * d + 2 * d * 2 * d)
                  + 2 * 2 * (L + 1) ** 2 * d)
           + 2 * d * 12 * 512)
    got = yardstick.decision_flops(ATTN, np.array([L, 500]))
    assert got[0] == pytest.approx(enc + heads)
    assert got[1] == yardstick.decision_flops(ATTN, 128)


def test_mfu_reader():
    read = harness.metric_reader(ROOT, "mfu.sweep")
    ctx = SimpleNamespace(config=MLP, qlens=None, window_s=2.0,
                          window=SimpleNamespace(decisions=3000))
    want = 100 * 3000 * yardstick.decision_flops(MLP) / (2.0 * 495e12)
    assert read(ctx) == pytest.approx(want)
    deciding = np.array([[True, False], [True, True]])
    ctx = SimpleNamespace(config=ATTN, qlens=[np.array([1.0, 7.0]),
                                             np.array([2.0, 3.0])],
                          deciding=deciding, window_s=1.0,
                          window=SimpleNamespace(decisions=6))
    per = yardstick.decision_flops(ATTN, np.array([1.0, 2.0, 3.0])).sum()
    assert read(ctx) == pytest.approx(100 * 2 * per / 495e12)


def _front_layout():
    return SimpleNamespace(n_envs=8, n_jobs=20, n_units=50, n_resources=2,
                           window=10, queue_cap=0, state_module="mlp",
                           state_dim=140)


def test_b4_reader_costs_every_traced_call():
    """The probe's mean call, times the calls the trace holds, whether
    or not the traced rollouts made as many calls as the probe's."""
    read = harness.metric_reader(ROOT, "b4_roofline")
    front = np.array([[3, 2, 5, 3], [1, 4, 5, 1]])
    lay = _front_layout()
    per = [yardstick.bound_s(*yardstick.front_cost(
        yardstick.FrontCall(8, 20, *row), 2, 50, 10, 140 + 4 + 10))
        for row in front]
    for calls in (2, 7):
        trace = yardstick.DeviceTrace(
            {"decision_rows_kernel": yardstick.DeviceOp(
                "decision_rows_kernel", calls, 1e-3)}, [])
        ctx = SimpleNamespace(trace=trace, front=front, layout=lay)
        assert read(ctx) == pytest.approx(
            100 * np.mean(per) * calls / 1e-3)


def test_b5_reader_costs_every_traced_launch():
    read = harness.metric_reader(ROOT, "b5_roofline")
    qlens = [np.array([0.0, 3.0]), np.array([200.0, 5.0])]
    per = [yardstick.bound_s(*yardstick.mha_cost(4 * kept, 2 * 4, 129, 16))
           for kept in (1 + 4, 129 + 6)]
    trace = yardstick.DeviceTrace(
        {"mha_fwd_kernel": yardstick.DeviceOp("mha_fwd_kernel", 6, 2e-4)},
        [])
    ctx = SimpleNamespace(config=ATTN, trace=trace, qlens=qlens,
                          layout=SimpleNamespace(n_envs=2))
    assert read(ctx) == pytest.approx(100 * np.mean(per) * 6 / 2e-4)


def test_busy_union_and_breakdown():
    iv = [(0, 10, "void a_kernel<float>(float*)"), (5, 12, "b"),
          (20, 30, "a_kernel"), (40, 41, "c")]
    assert yardstick.busy_seconds(iv) == pytest.approx(23e-9)
    tr = yardstick.DeviceTrace(
        {"a_kernel": yardstick.DeviceOp("a_kernel", 2, 2e-8),
         "b": yardstick.DeviceOp("b", 1, 7e-9)}, iv)
    bd = yardstick.breakdown(tr)
    assert bd["device_ops"][0] == ["a_kernel", 2e-8]
    gaps = dict(bd["idle_gaps"])
    assert gaps["b -> a_kernel"] == pytest.approx(8e-9)
    assert gaps["a_kernel -> c"] == pytest.approx(1e-8)
    assert yardstick.short_name("void k<1, 2>(int)") == "k"
    assert yardstick.short_name(
        "void (anonymous namespace)::f_kernel<float, true>(float const*)"
    ) == "f_kernel"


def test_roofline_readers_see_nothing_without_a_trace():
    empty = yardstick.DeviceTrace({}, [])
    ctx = SimpleNamespace(config=ATTN, trace=empty, qlens=[np.zeros(2)],
                          front=np.zeros((0, 4)),
                          window=SimpleNamespace(deciding_rounds=1,
                                                 rounds_run=1, host_syncs=1),
                          layout=SimpleNamespace(n_envs=2), window_s=1.0)
    for name in ("b1_roofline.sweep", "b4_roofline", "b5_roofline",
                 "idle_share.sweep", "device_ops_per_round"):
        assert harness.metric_reader(ROOT, name)(ctx) is None
