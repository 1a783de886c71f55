"""The port's evaluation matrix and tournament (``repro_torch.eval``) under
tests/test_matrix.py's and tests/test_tournament.py's contracts at their
mini sizes, and against the JAX package's on the same cells with
converted parameters (the MRSch agent, ScalarRL, DRAS and CoSchedRL):
rows at 4 decimals, the committed baselines' columns and entrants, the
standings and the rendered leaderboard; a crashing entrant's cells are
recorded as failed, not dropped."""
import json
from pathlib import Path

import pytest

from _torch_parity import (agent_pair, guard_window_policy, jax_tree_numpy,
                           values_and_margin)
from repro import eval as jeval
from repro.workloads import ThetaConfig as JThetaConfig
from repro_torch.convert import load_policy_params
from repro_torch.eval import (MATRIX_SCHEMA, TOURNAMENT_SCHEMA, MatrixConfig,
                              TournamentConfig, default_policies,
                              leaderboard_columns, matrix_columns,
                              matrix_csv, render_leaderboard, run_matrix,
                              run_tournament, save_matrix, save_tournament,
                              zoo_policies)
from repro_torch.eval.tournament import _ranks
from repro_torch.workloads import ThetaConfig

REPO = Path(__file__).resolve().parent.parent
BASELINES = REPO / "benchmarks" / "baselines"
MATRIX_CELLS = dict(scenarios=("S2", "drift-bb-surge"), seeds=(1,), vector=4)
TOURNEY_CELLS = dict(scenarios=("S2", "bursty-campaigns"), seeds=(1,),
                     vector=4)
MARGIN_TOL = 1e-4
CONVERTED = ("ScalarRL", "DRAS", "CoSchedRL")


def mini(pkg, per_day):
    cfg = (ThetaConfig if pkg == "torch" else JThetaConfig).mini(
        seed=0, duration_days=0.4, jobs_per_day=per_day)
    return cfg, cfg.resources()


def guard_agent(agent, margins):
    """Keep the top-2 margin of every row the agent scores in a batch."""
    greedy_rows = agent._greedy_rows

    def guarded(rows):
        margins.extend(values_and_margin(agent, rows)[1].tolist())
        return greedy_rows(rows)

    agent._greedy_rows = guarded


def paired_fields(jfactory, tfactory, per_day):
    """The reference's field and the port's (CPU) on the same mini cells,
    the port's networks holding the reference's parameters and guarded:
    every batched decision's top-2 margin is kept in ``margins``."""
    jcfg, jres = mini("jax", per_day)
    cfg, res = mini("torch", per_day)
    ja, ta = agent_pair(res)
    jpols = jfactory(jres, agent=ja)
    tpols = tfactory(res, agent=ta, device="cpu")
    margins = []
    guard_agent(ta, margins)
    for name in CONVERTED:
        if name in tpols:
            load_policy_params(tpols[name](),
                               jax_tree_numpy(jpols[name]().params))
            guard_window_policy(tpols[name](), margins)
    return (jpols, jres, jcfg), (tpols, res, cfg), margins


@pytest.fixture(scope="module")
def matrices():
    (jpols, jres, jcfg), (tpols, res, cfg), margins = paired_fields(
        jeval.default_policies, default_policies, 110)
    want = jeval.run_matrix(jpols, jres, jcfg,
                            jeval.MatrixConfig(**MATRIX_CELLS))
    got = run_matrix(tpols, res, cfg, MatrixConfig(**MATRIX_CELLS))
    return got, want, margins


@pytest.fixture(scope="module")
def matrix():
    cfg, res = mini("torch", 110)
    return run_matrix(default_policies(res, device="cpu"), res, cfg,
                      MatrixConfig(**MATRIX_CELLS))


@pytest.fixture(scope="module")
def tourneys():
    (jpols, jres, jcfg), (tpols, res, cfg), margins = paired_fields(
        jeval.zoo_policies, zoo_policies, 140)
    want = jeval.run_tournament(jpols, jres, jcfg,
                                jeval.TournamentConfig(**TOURNEY_CELLS))
    got = run_tournament(tpols, res, cfg, TournamentConfig(**TOURNEY_CELLS))
    return got, want, margins


# ------------------------------------------------------------------ matrix
def test_matrix_schema_and_grid_shape(matrix):
    _, res = mini("torch", 110)
    assert matrix["schema"] == MATRIX_SCHEMA
    assert matrix["columns"] == matrix_columns(res)
    assert matrix["summary"]["n_cells"] == 2 * 3     # scenarios x policies
    assert matrix["summary"]["batched_policies"] == 2     # FCFS, ScalarRL
    for row in matrix["rows"]:
        assert list(row) == matrix["columns"]


def test_matrix_rows_flag_drift_and_family(matrix):
    by_scenario = {}
    for r in matrix["rows"]:
        by_scenario.setdefault(r["scenario"], set()).add(r["drift"])
    assert by_scenario == {"S2": {False}, "drift-bb-surge": {True}}


def test_matrix_is_deterministic_and_width_free(matrix):
    """The same grid again, and with lockstep width 1."""
    cfg, res = mini("torch", 110)
    for vector in (4, 1):
        again = run_matrix(default_policies(res, device="cpu"), res, cfg,
                           MatrixConfig(**{**MATRIX_CELLS, "vector": vector}))
        assert again["rows"] == matrix["rows"]
        assert again["summary"]["wins"] == matrix["summary"]["wins"]


def test_matrix_csv_and_save(matrix, tmp_path):
    lines = matrix_csv(matrix).strip().splitlines()
    assert lines[0] == ",".join(matrix["columns"])
    assert len(lines) == 1 + len(matrix["rows"])
    jp, cp = save_matrix(matrix, str(tmp_path / "m.json"))
    assert json.load(open(jp))["schema"] == MATRIX_SCHEMA
    assert open(cp).read() == matrix_csv(matrix)


def test_power_scenarios_need_power_resource():
    cfg, res = mini("torch", 110)
    with pytest.raises(ValueError, match="power"):
        run_matrix(default_policies(res, device="cpu"), res, cfg,
                   MatrixConfig(scenarios=("S7",), seeds=(1,)))


def test_matrix_rows_equal_reference(matrices):
    """FCFS, GA, ScalarRL and MRSch over both cells: every row equal at
    the schema's 4 decimals, in the committed baseline's column order."""
    got, want, margins = matrices
    assert margins and min(margins) > MARGIN_TOL, min(margins)
    committed = json.load(open(BASELINES / "matrix.json"))
    assert got["columns"] == want["columns"] == committed["columns"]
    assert got["config"]["policies"] == ["FCFS", "GA", "ScalarRL", "MRSch"]
    assert got["rows"] == want["rows"]
    assert matrix_csv(got) == jeval.matrix_csv(want)
    assert got["summary"]["wins"] == want["summary"]["wins"]
    assert got["summary"]["batched_policies"] == 3
    assert got["config"] == want["config"]


# -------------------------------------------------------------- tournament
def test_tournament_equals_reference(tourneys):
    """The eight entrants (the MRSch agent included): rows, standings,
    head-to-head, the improvement figure and the rendered leaderboard
    equal the reference's."""
    got, want, margins = tourneys
    assert margins and min(margins) > MARGIN_TOL, min(margins)
    assert got["schema"] == TOURNAMENT_SCHEMA
    for key in ("columns", "leaderboard_columns", "config", "rows",
                "leaderboard", "per_policy", "ranks", "head_to_head",
                "relative_improvement"):
        assert got[key] == want[key], key
    strip = ("wall_seconds",)
    assert ({k: v for k, v in got["summary"].items() if k not in strip}
            == {k: v for k, v in want["summary"].items() if k not in strip})
    assert render_leaderboard(got) == jeval.render_leaderboard(want)


def test_tournament_schema_against_committed_baseline(tourneys):
    got, _, _ = tourneys
    committed = json.load(open(BASELINES / "tournament.json"))
    matrix = json.load(open(BASELINES / "matrix.json"))
    assert got["columns"] == matrix["columns"]
    assert got["config"]["policies"] == committed["config"]["policies"]
    assert got["config"]["resources"] == committed["config"]["resources"]
    for p, metrics in committed["per_policy"].items():
        assert list(got["per_policy"][p]) == list(metrics), p
    assert got["leaderboard_columns"] == [
        "rank", "policy", "overall_score", "wins", "h2h_win_rate",
        "avg_wait", "avg_slowdown", "p95_wait", "util_node", "util_bb",
        "wait_improvement_vs"]
    _, res = mini("torch", 140)
    assert got["leaderboard_columns"] == leaderboard_columns(res)
    for entry in got["leaderboard"]:
        assert list(entry) == got["leaderboard_columns"]
    assert got["summary"]["n_cells"] == 8 * 2
    assert got["summary"]["batched_policies"] == 7
    assert not got["summary"]["failures"]


def test_leaderboard_ranks_and_head_to_head(tourneys):
    t, _, _ = tourneys
    lb = t["leaderboard"]
    assert [e["rank"] for e in lb] == list(range(1, len(lb) + 1))
    key = [(-e["overall_score"], e["policy"]) for e in lb]
    assert key == sorted(key)
    for metric, ranks in t["ranks"].items():
        assert sorted(ranks.values()) == list(range(1, len(lb) + 1)), metric
    h2h = t["head_to_head"]
    for p in h2h:
        for q, rate in h2h[p].items():
            assert 0.0 <= rate <= 1.0 and rate + h2h[q][p] <= 1.0 + 1e-9


def test_ranks_direction_and_tiebreak():
    agg = {"A": {"avg_wait": 10.0}, "B": {"avg_wait": 5.0},
           "C": {"avg_wait": 10.0}}
    assert _ranks(agg, "avg_wait", lower_is_better=True) \
        == {"B": 1, "A": 2, "C": 3}
    assert _ranks(agg, "avg_wait", lower_is_better=False) \
        == {"A": 1, "C": 2, "B": 3}


def test_render_and_save(tourneys, tmp_path):
    t, _, _ = tourneys
    md = render_leaderboard(t)
    assert "MRSch relative wait improvement" in md
    jp, mp = save_tournament(t, str(tmp_path / "t.json"))
    assert json.load(open(jp))["schema"] == TOURNAMENT_SCHEMA
    assert mp.endswith("leaderboard.md") and open(mp).read() == md


class BoomPolicy:
    """Deliberately crashing entrant (the partial-failure contract)."""
    requires_obs = False

    def select(self, ctx):
        raise RuntimeError("boom")


def test_crashing_policy_marks_cells_failed_not_dropped():
    cfg, res = mini("torch", 140)
    pols = dict(zoo_policies(res, device="cpu"))
    pols["Boom"] = BoomPolicy
    t = run_tournament(pols, res, cfg, TournamentConfig(**TOURNEY_CELLS))
    fails = t["summary"]["failures"]
    assert [f["policy"] for f in fails] == ["Boom"]
    assert "RuntimeError: boom" in fails[0]["error"]
    assert t["summary"]["n_failed_cells"] == 2
    assert t["summary"]["n_cells"] == 7 * 2
    assert "Boom" not in {e["policy"] for e in t["leaderboard"]}
    assert "FAILED policies" in render_leaderboard(t)
