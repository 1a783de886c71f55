"""The fleet scheduler (``launch/scheduler.py``) and its cost model
(``distributed/costs.py``) against the JAX package's: the cost tables and
demand vectors bit for bit, the synthetic fleet traces job for job, the
FCFS and GA schedules' metrics rows exactly, and the MRSch schedule of an
agent whose weights are copied from the reference's, every greedy
decision's top-2 margin guarded."""
import copy
import dataclasses

import numpy as np
import pytest

from _torch_parity import agent_pair, values_and_margin
from repro.configs import SHAPES as JSHAPES
from repro.configs import all_configs as jall_configs
from repro.distributed import costs as jcosts
from repro.launch import scheduler as jsched
from repro_torch.configs import SHAPES as TSHAPES
from repro_torch.configs import all_configs as tall_configs
from repro_torch.core.encoding import decision_row_dim, encode_decision_row
from repro_torch.distributed import costs as tcosts
from repro_torch.launch import scheduler as tsched

MARGIN_TOL = 1e-5


@pytest.mark.parametrize("arch", sorted(tall_configs()))
def test_cell_costs_and_flash_correction_match_reference(arch):
    jcfg, tcfg = jall_configs()[arch], tall_configs()[arch]
    for sname in TSHAPES:
        want = jcosts.cell_costs(jcfg, JSHAPES[sname])
        got = tcosts.cell_costs(tcfg, TSHAPES[sname])
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for block in (tcosts.FLASH_BLOCK_K, 512):
            assert tcosts.flash_correction(tcfg, TSHAPES[sname], block) == \
                jcosts.flash_correction(jcfg, JSHAPES[sname], block)
    assert (tcosts.FLASH_BLOCK_K, tcosts.DENSE_ATTN_THRESHOLD) == \
        (jcosts.FLASH_BLOCK_K, jcosts.DENSE_ATTN_THRESHOLD)


def test_job_demands_match_reference():
    fleets = [(jsched.FleetSpec(), tsched.FleetSpec()),
              (jsched.FleetSpec(hbm_gb_per_chip=80.0, watts_per_chip=700.0),
               tsched.FleetSpec(hbm_gb_per_chip=80.0, watts_per_chip=700.0))]
    assert dataclasses.asdict(fleets[0][1]) == dataclasses.asdict(fleets[0][0])
    for jf, tf in fleets:
        assert [(r.name, r.capacity, r.unit) for r in tf.resources()] == \
            [(r.name, r.capacity, r.unit) for r in jf.resources()]
        for arch in tall_configs():
            for sname in ("train_4k", "prefill_32k", "decode_32k"):
                assert tsched.job_demands(arch, sname, tf) == \
                    jsched.job_demands(arch, sname, jf), (arch, sname)


def _jobs(jobs):
    return [(j.jid, j.submit, j.runtime, j.walltime, j.demands) for j in jobs]


@pytest.mark.parametrize("n, seed", [(30, 5), (25, 0)])
def test_synth_fleet_trace_matches_reference(n, seed):
    got = tsched.synth_fleet_trace(tsched.FleetSpec(), n, seed=seed)
    want = jsched.synth_fleet_trace(jsched.FleetSpec(), n, seed=seed)
    assert _jobs(got) == _jobs(want)


@pytest.mark.parametrize("policy, n", [("fcfs", 60), ("ga", 20)])
def test_schedule_fleet_matches_reference(policy, n):
    got = tsched.schedule_fleet(
        tsched.synth_fleet_trace(tsched.FleetSpec(), n, seed=1000),
        tsched.FleetSpec(), policy)
    want = jsched.schedule_fleet(
        jsched.synth_fleet_trace(jsched.FleetSpec(), n, seed=1000),
        jsched.FleetSpec(), policy)
    assert got.metrics.as_row() == want.metrics.as_row()
    assert got.decisions == want.decisions


def _record_rows(agent, rows):
    """Keep each greedy decision's packed row (their top-2 margins are
    read after the run, in one float64 pass on the plain backend: the
    weights do not change while the agent schedules)."""
    select = agent.select

    def recording(ctx):
        w = agent.config.window
        row = np.zeros(decision_row_dim(agent.enc, w), np.float32)
        encode_decision_row(agent.enc, ctx, w, out=row)
        rows.append(row)
        return select(ctx)

    agent.select = recording


def test_mrsch_fleet_schedule_matches_reference():
    """The fleet agent's network (``fleet_agent_config``) with the
    reference's weights schedules the same fleet trace the same way."""
    knobs = dataclasses.asdict(tsched.fleet_agent_config(0))
    widths = {k: knobs[k] for k in ("state_hidden", "state_out",
                                    "module_hidden", "grad_steps_per_episode",
                                    "batch_size")}
    ja, ta = agent_pair(tsched.FleetSpec().resources(), seed=0, **widths)
    want = jsched.schedule_fleet(
        jsched.synth_fleet_trace(jsched.FleetSpec(), 40, seed=1000),
        jsched.FleetSpec(), "mrsch", agent=ja)
    for backend in ("torch", "kernel"):
        ta.set_backend(backend)
        agent = copy.copy(ta)
        rows = []
        _record_rows(agent, rows)
        got = tsched.schedule_fleet(
            tsched.synth_fleet_trace(tsched.FleetSpec(), 40, seed=1000),
            tsched.FleetSpec(), "mrsch", agent=agent)
        assert got.metrics.as_row() == want.metrics.as_row()
        assert got.decisions == want.decisions > 0
        assert len(rows) >= got.decisions
        margins = values_and_margin(ta, np.stack(rows))[1]
        assert margins.min() > MARGIN_TOL, margins.min()


def test_make_fleet_agent_trains_on_the_cpu():
    agent = tsched.make_fleet_agent(tsched.FleetSpec(), train_jobs=40,
                                    episodes=2, device="cpu")
    assert agent.device.type == "cpu"
    assert agent.replay.rows > 0 and agent.losses
    assert agent.epsilon < 1.0 and not agent.training
    result = tsched.schedule_fleet(
        tsched.synth_fleet_trace(tsched.FleetSpec(), 20, seed=3),
        tsched.FleetSpec(), "mrsch", agent=agent)
    assert result.metrics.as_row()["n_jobs"] == 20


def test_main_prints_the_reference_row(capsys):
    row = tsched.main(["--jobs", "20", "--policy", "fcfs", "--seed", "4"])
    want = jsched.schedule_fleet(
        jsched.synth_fleet_trace(jsched.FleetSpec(), 20, seed=1004),
        jsched.FleetSpec(), "fcfs").metrics.as_row()
    assert row == {"policy": "fcfs",
                   **{k: round(v, 4) for k, v in want.items()}}
    assert capsys.readouterr().out.strip().startswith('{"policy": "fcfs"')
