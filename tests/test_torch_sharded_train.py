"""One training step of the port on a (2, 4) ("data", "model") mesh of 8
spawned gloo CPU ranks, under ``default_rules`` (parameters fsdp- and
tensor-parallel DTensors, the stacked AdamW state sharded alike, the batch
over "data"), against the JAX package's single-device step from the same
weights: the loss and norm at the tolerances of the reference's own
sharded-step test, and each AdamW moment (so each gradient leaf) and each
parameter's update at those of the single-device step's test."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist
from repro.configs import smoke_config as jsmoke
from repro.configs.shapes import InputShape as JShape
from repro.data.pipeline import make_batch as jmake_batch
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import transformer as jtransformer
from repro.optim import OptConfig as JOptConfig
from repro.optim import opt_init as jopt_init
from repro_torch.convert import _flatten, lm_params_from_jax
from repro_torch.configs import smoke_config as tsmoke

ARCH = "stablelm-1.6b"
SSM_ARCH = "mamba2-1.3b"          # the conv and the chunked SSD on local shards
LR = 1e-3


def reference_step(arch: str) -> dict:
    """The reference's single-device step of ``arch``'s smoke config from
    seed 0 (B = 4, S = 64, lr ``LR``, no weight decay): its ``batch`` (int64)
    and ``state`` (the first weights, converted; ``jparams`` as the
    reference holds them), its metrics ``m1``, new parameters ``want`` and
    AdamW leaves ``moments`` by dotted path."""
    cfg = jsmoke(arch)
    batch = jmake_batch(cfg, JShape("t", 64, 4, "train"), 0)
    params = jtransformer.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    opt = JOptConfig(lr=LR, weight_decay=0.0)
    p1, s1, m1 = jax.jit(jmake_train_step(cfg, opt))(
        params, jopt_init(params, opt), batch)
    lm = lm_params_from_jax(jax.tree.map(np.asarray, params), tsmoke(arch),
                            device="cpu")
    want = lm_params_from_jax(jax.tree.map(np.asarray, p1), tsmoke(arch),
                              device="cpu")
    moments = {}
    _flatten(s1["leaves"], "leaves.", moments,
             leaf=lambda x: np.asarray(x, np.float32))
    return {"batch": {k: np.asarray(v).astype(np.int64)
                      for k, v in batch.items()},
            "state": _torch_dist.as_numpy_state(lm), "jparams": params,
            "m1": m1,
            "want": _torch_dist.as_numpy_state(want), "moments": moments}


def sharded_and_reference(arch: str, tmp) -> tuple:
    """(the sharded step's result from rank 0, the reference's metrics,
    new parameters, AdamW leaves by dotted path, the first parameters)."""
    ref = reference_step(arch)
    got = _torch_dist.run_ranks(_torch_dist.train_step, tmp, arch,
                                ref["batch"], ref["state"])
    return got, ref["m1"], ref["want"], ref["moments"], ref["state"]


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return sharded_and_reference(ARCH, tmp_path_factory.mktemp("train"))


@pytest.fixture(scope="module")
def ssm_steps(tmp_path_factory):
    return sharded_and_reference(SSM_ARCH, tmp_path_factory.mktemp("ssm"))


def check_loss(got, m1) -> None:
    assert abs(got["loss"] - float(m1["loss"])) < 2e-3
    np.testing.assert_allclose(got["grad_norm"], float(m1["grad_norm"]),
                               rtol=3e-3)
    assert got["step"] == 1


def first_moment(moments, name: str) -> np.ndarray:
    """The reference's m for the port's parameter ``name`` (a layer's
    ``stack.<i>.…`` reads row i of the stacked leaf)."""
    hit = re.match(r"^(stack|prefix)\.(\d+)\.(.*)$", name)
    if hit is None:
        return moments[f"leaves.{name}.m"]
    return moments[f"leaves.{hit[1]}.{hit[3]}.m"][int(hit[2])]


def check_parameters(got, want, before, moments) -> None:
    """The new parameters at the reference's sharded-step tolerances, and
    each element's update ``p1 - p0`` within lr / 8 of the reference's:
    AdamW's first step moves each element by about lr, so a parameter
    left in place or stepped with the wrong sign is off by lr or 2 lr.
    Where the reference's |g| is below 1e-3 of its leaf's largest (its m,
    0.1 g times the clip scale, is read for |g|), u = m / (sqrt(v) + eps)
    turns on the gradient's last digits, which the ranks' sums order
    otherwise; there the update is held to one step's bound, 2 lr, and
    the gradient itself by ``check_moments``."""
    assert set(got["params"]) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(got["params"][n], w, rtol=3e-3, atol=3e-3,
                                   err_msg=n)
        g = np.abs(first_moment(moments, n))
        small = g < 1e-3 * g.max()
        step, ref = got["params"][n] - before[n], w - before[n]
        np.testing.assert_allclose(step[~small], ref[~small], rtol=0.0,
                                   atol=LR / 8, err_msg=n)
        assert np.all(np.abs(step[small]) <= 2 * LR), n


def check_moments(got, want) -> None:
    """Every AdamW moment leaf of the stacked state against the
    reference's: m is 0.1 g times the clip scale, so this holds each
    gradient leaf; within rtol 1e-3 (v, squared, 2e-3) and 1e-3 of the
    leaf's largest, as the single-device step's test."""
    assert got.keys() == want.keys()
    for path, w in want.items():
        rtol = 2e-3 if path.split(".")[-1] in ("v", "vr", "vc") else 1e-3
        np.testing.assert_allclose(got[path], w, rtol=rtol,
                                   atol=1e-3 * float(np.abs(w).max()),
                                   err_msg=path)


def test_sharded_step_loss_matches_single_device(steps):
    check_loss(*steps[:2])


def test_sharded_step_parameters_match_single_device(steps):
    got, _, want, moments, before = steps
    check_parameters(got, want, before, moments)


def test_sharded_step_moments_match_single_device(steps):
    """The vocab-parallel embedding's and the attention cores' gradients
    (on local shards) among them."""
    check_moments(steps[0]["opt"], steps[3])


def test_sharded_ssm_step_loss_matches_single_device(ssm_steps):
    check_loss(*ssm_steps[:2])


def test_sharded_ssm_step_parameters_match_single_device(ssm_steps):
    got, _, want, moments, before = ssm_steps
    check_parameters(got, want, before, moments)


def test_sharded_ssm_step_moments_match_single_device(ssm_steps):
    """The conv's weights and the chunked SSD's B and C are read alike by
    the ranks that split the channels and the heads: their gradients sum
    over those ranks."""
    check_moments(ssm_steps[0]["opt"], ssm_steps[3])


def test_sharded_step_keeps_the_rules_layout(steps):
    """The updated parameters stay where the rules put them: fsdp over
    "data", heads / mlp / vocab over "model"."""
    pl = steps[0]["placements"]
    assert pl["stack.0.attn.wq"] == "(Shard(dim=0), Shard(dim=1))"
    assert pl["stack.0.mlp.w_down"] == "(Shard(dim=1), Shard(dim=0))"
    assert pl["embed.table"] == "(Shard(dim=1), Shard(dim=0))"
    assert pl["final_norm.scale"] == "(Replicate(), Replicate())"
