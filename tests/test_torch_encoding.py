"""The port's state encoding, measurement, Eq. (1) goal and packed decision
rows are bit-identical to the JAX package's on contexts harvested from both
simulators running in lockstep."""
import numpy as np

import repro.core.encoding as jenc
import repro.core.goal as jgoal
import repro_torch.core.encoding as tenc
import repro_torch.core.goal as tgoal
from _torch_parity import PKGS, SlotPolicy, faulty_mini, theta_mini

ENC = {"jax": jenc, "torch": tenc}
GOAL = {"jax": jgoal, "torch": tgoal}


def _encodings(pkg, cfg, ctx, n_actions):
    e = ENC[pkg]
    row = np.zeros(e.decision_row_dim(cfg, n_actions), np.float32)
    goal_used = e.encode_decision_row(cfg, ctx, n_actions, out=row)
    override = np.asarray([0.25, 0.75], np.float32)
    row_override = np.zeros_like(row)
    e.encode_decision_row(cfg, ctx, n_actions, out=row_override,
                          goal=override)
    return {"state": e.encode_state(cfg, ctx),
            "meas": e.encode_measurement(cfg, ctx),
            "goal": GOAL[pkg].ctx_goal(ctx, cfg.resource_names),
            "row": row, "goal_used": goal_used, "row_override": row_override,
            "padded": e.pad_decision_rows(np.stack([row, row_override]), 4,
                                          cfg)}


def _lockstep(setup, window=10, limit=400):
    """Drive both simulators with one policy; compare every decision."""
    sims, cfgs = {}, {}
    for pkg, sim in PKGS.items():
        res, jobs, faults = setup(pkg)
        sims[pkg] = sim.Simulator(res, jobs, SlotPolicy(rotate=True),
                                  sim.SimConfig(window=window), faults=faults)
        caps = tuple(r.capacity for r in res)
        names = tuple(r.name for r in res)
        cfgs[pkg] = ENC[pkg].EncodingConfig(window=window,
                                            resource_names=names,
                                            capacities=caps)
    assert cfgs["jax"].state_dim == cfgs["torch"].state_dim
    pol = SlotPolicy(rotate=True)
    n = 0
    while n < limit:
        ctxs = {pkg: s.next_decision() for pkg, s in sims.items()}
        if ctxs["jax"] is None:
            assert ctxs["torch"] is None
            break
        got = {pkg: _encodings(pkg, cfgs[pkg], c, window)
               for pkg, c in ctxs.items()}
        for key, ref in got["jax"].items():
            out = got["torch"][key]
            assert out.dtype == ref.dtype and out.shape == ref.shape, key
            assert np.array_equal(out, ref), (n, key)   # bit for bit
        a = pol.select(ctxs["jax"])
        for s in sims.values():
            s.post_action(a)
        n += 1
    return n


def test_encoding_identical_on_mini_s2():
    n = _lockstep(lambda pkg: (*theta_mini(pkg, "S2", days=0.6), None))
    assert n > 100


def test_encoding_identical_with_drains():
    """A permanent drain leaves +inf release times: the 30-day time-to-free
    clamp (TTF_HORIZON) must hold in both packages."""
    n = _lockstep(faulty_mini)
    assert n > 100


def test_state_dim_matches_paper():
    from repro_torch.workloads import ThetaConfig
    res = ThetaConfig().resources()
    cfg = tenc.EncodingConfig(10, tuple(r.name for r in res),
                              tuple(r.capacity for r in res))
    assert cfg.state_dim == 11410
