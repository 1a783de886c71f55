"""The port's ``WindowPolicy`` against the JAX package's: the observation
stage (``requires_obs`` by default, ``enc``, ``_encode_rows``,
``_n_actions``, the ``training`` guard), a row-scoring subclass on the
host batched stage and in both device engines, and FCFS staying
mask-only."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.policy_api as jpa
import repro_torch.core.policy_api as tpa
from _torch_parity import PKGS, synth_jobs
from repro.core import FCFSPolicy as JFCFS
from repro.core.encoding import EncodingConfig as JEnc
from repro_torch.core import FCFSPolicy as TFCFS
from repro_torch.core.encoding import EncodingConfig as TEnc

W = 10
JOB_DIM = 4                    # two resources + walltime + queued time


def res(pkg):
    sim = PKGS[pkg]
    return [sim.ResourceSpec("node", 16), sim.ResourceSpec("bb", 8)]


class JWidest(jpa.WindowPolicy):
    """Widest job first: scores each window slot by its node-demand
    column of the packed row; earlier slots win ties."""

    def __init__(self, window=W):
        self.enc = JEnc(window=window, resource_names=("node", "bb"),
                        capacities=(16, 8))

    def score_window(self, policy_state, obs):
        cols = jnp.arange(self.enc.window) * JOB_DIM
        return obs[:, cols] - 1e-3 * jnp.arange(self.enc.window,
                                                dtype=jnp.float32)


class TWidest(tpa.WindowPolicy):
    """The same policy on the port's base class."""

    def __init__(self, window=W):
        self.enc = TEnc(window=window, resource_names=("node", "bb"),
                        capacities=(16, 8))

    def score_window(self, policy_state, obs):
        w = self.enc.window
        cols = torch.arange(w, device=obs.device) * JOB_DIM
        return obs[:, cols] - 1e-3 * torch.arange(w, dtype=torch.float32,
                                                  device=obs.device)


WIDEST = {"jax": JWidest, "torch": TWidest}
FCFS = {"jax": JFCFS, "torch": TFCFS}


def contexts(pkg, n_envs=6, depth=4):
    """Pending decisions a few FCFS steps into each of ``n_envs`` traces
    (windows of every length up to W)."""
    sim = PKGS[pkg]
    ctxs = []
    for s in range(n_envs):
        simu = sim.Simulator(res(pkg), synth_jobs(sim, s, n=40), None)
        ctx = simu.next_decision()
        for _ in range(depth):
            if ctx is None:
                break
            simu.post_action(0)
            ctx = simu.next_decision()
        while ctx is not None:
            ctxs.append(ctx)
            simu.post_action(0)
            ctx = simu.next_decision()
            if len(ctxs) % 5 == 0:
                break
    return ctxs


def test_class_defaults_match_reference():
    for attr in ("requires_obs", "enc", "training"):
        assert getattr(tpa.WindowPolicy, attr) == \
            getattr(jpa.WindowPolicy, attr), attr
    assert tpa.WindowPolicy.requires_obs is True
    assert TFCFS.requires_obs is False and JFCFS.requires_obs is False
    assert TWidest().requires_obs and TWidest()._n_actions([]) == W


def test_row_scoring_policy_matches_reference():
    got = {pkg: WIDEST[pkg]().select_batch(contexts(pkg)) for pkg in PKGS}
    assert got["torch"].dtype == np.int32
    np.testing.assert_array_equal(got["torch"], got["jax"])
    assert len(set(got["torch"].tolist())) > 1         # not always the head
    ctxs = contexts("torch")
    assert [TWidest().select(c) for c in ctxs] == \
        got["torch"].tolist()


def test_encode_rows_match_reference():
    rows = {pkg: WIDEST[pkg]()._encode_rows(contexts(pkg), W)
            for pkg in PKGS}
    assert rows["torch"].dtype == np.float32
    np.testing.assert_array_equal(rows["torch"], rows["jax"])


def test_training_guard_raises_on_both():
    for pkg in PKGS:
        pol = WIDEST[pkg]()
        pol.training = True
        with pytest.raises(RuntimeError, match="evaluation-only"):
            pol.select_batch(contexts(pkg, n_envs=1))


def test_requires_obs_without_enc_is_refused():
    class NoEnc(tpa.WindowPolicy):
        def score_window(self, policy_state, obs):
            return obs[:, :W]

    with pytest.raises(AssertionError, match="EncodingConfig"):
        NoEnc().select_batch(contexts("torch", n_envs=1))
    with pytest.raises(ValueError, match="requires obs but has no enc"):
        PKGS["torch"].DeviceSimulator(res("torch"),
                                      [synth_jobs(PKGS["torch"], 0, n=5)],
                                      NoEnc(), device="cpu")


@pytest.mark.parametrize("seed", [0, 3])
def test_row_scoring_policy_in_both_device_engines(seed):
    out = {}
    for pkg in PKGS:
        sim = PKGS[pkg]
        extra = {"device": "cpu"} if pkg == "torch" else {}
        ds = sim.DeviceSimulator(res(pkg), [synth_jobs(sim, seed, n=30)],
                                 WIDEST[pkg](), **extra)
        out[pkg] = ds.rollout()
    np.testing.assert_array_equal(out["torch"].actions, out["jax"].actions)
    np.testing.assert_array_equal(out["torch"].decided, out["jax"].decided)
    assert out["torch"].actions[out["torch"].decided].any()


def test_fcfs_stays_mask_only():
    """FCFS scores the window-valid mask: its host stage never encodes a
    row and its device rollout runs without an ``enc``."""
    pol = TFCFS()
    pol._encode_rows = None                     # would fail if called
    ctxs = contexts("torch")
    assert list(pol.select_batch(ctxs)) == [0] * len(ctxs)
    np.testing.assert_array_equal(pol.select_batch(ctxs),
                                  JFCFS().select_batch(contexts("jax")))
    ro = PKGS["torch"].DeviceSimulator(
        res("torch"), [synth_jobs(PKGS["torch"], 1, n=20)], pol,
        device="cpu").rollout()
    assert ro.decided.any() and not ro.actions[ro.decided].any()
