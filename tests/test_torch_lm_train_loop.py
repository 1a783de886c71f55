"""The port's LM train step and training driver (``repro_torch.launch``)
against the JAX package's: one ``make_train_step`` step on four smoke
configs; a restart of ``train_loop`` resumes from the latest checkpoint;
checkpoints written by either package's ``train_loop`` restore in the
other and continue to the reference's losses, with identical manifests;
a SIGTERM flushes a checkpoint and ends the loop; the command line
prints the reference's JSON.  The loops run stablelm-1.6b's smoke config
at B = 2, S = 32 on the CPU; float32 parameters; weights of the steps
from the reference, converted.  The reference's steps are jitted; each
tolerance is stated where it is used."""
import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from _torch_lm import batches, flat, reference
from repro import configs as jconfigs
from repro import optim as joptim
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro_torch import configs
from repro_torch.convert import lm_params_to_tree
from repro_torch.launch import make_train_step, train
from repro_torch.models import transformer
from repro_torch.optim import OptConfig, make_schedule, opt_init

ARCH = "stablelm-1.6b"
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
# Losses of ~6.7 after a few AdamW steps in two packages: float32 sums in
# another order compound over the steps.
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)


def _run(pkg, steps, ckpt_dir, log_every=1):
    if pkg == "jax":
        return jtrain.train_loop(
            jconfigs.smoke_config(ARCH), jconfigs.InputShape(
                "t", 32, 2, "train"), steps=steps, ckpt_dir=ckpt_dir,
            ckpt_every=2, log_every=log_every)
    return train.train_loop(
        configs.smoke_config(ARCH), configs.InputShape("t", 32, 2, "train"),
        steps=steps, ckpt_dir=ckpt_dir, ckpt_every=2, log_every=log_every,
        device="cpu")


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return [(leaf["path"], leaf["shape"], leaf["dtype"])
                for leaf in json.load(f)["leaves"]]


# ------------------------------------------------------------- train step
STEP_CASES = {
    "stablelm-1.6b": dict(microbatches=2),
    "deepseek-v2-lite-16b": dict(microbatches=2),
    "zamba2-7b": dict(microbatches=2, factored=True),
    "musicgen-medium": dict(microbatches=1),
}


@pytest.mark.parametrize("arch", list(STEP_CASES))
def test_train_step_matches_reference(arch):
    """``make_train_step`` against the reference's, both under a cosine
    schedule (peak 1e-3, warmup 1, total 10) and with weight decay 0.1,
    for two steps on one batch (B = 2, S = 64; microbatches as listed;
    zamba2-7b's state factored).  The first step's rate is 0 (the warmup
    starts there), so it moves no parameter and the second step meets the
    same parameters and batch: both steps' loss within 2e-4 and norm
    within rtol 1e-4.  After the second: each moment within rtol 1e-3 and
    1e-3 of its leaf's largest (the gradients' tolerance; v is squared,
    so 2e-3); the parameters within rtol 1e-4, atol 1e-6, except where
    the reference's |g| is below 1e-3 of its leaf's largest (its first
    moment, 0.19 g times the clip scale, is used for |g|): there
    u = m / (sqrt(v) + eps) is sensitive to the gradient's last digits,
    and those elements are held to the bound of one step,
    |new - old| <= 2 lr, and to the reference's new value within lr / 8
    (the largest such error is 0.017 lr; an update of the wrong sign is
    off by up to 2 lr |u|)."""
    case = STEP_CASES[arch]
    jcfg, cfg, tree, lm = reference(arch)
    jbatch, batch = batches(jcfg, cfg)
    factored = case.get("factored", False)
    jopt = joptim.OptConfig(factored=factored, weight_decay=0.1)
    opt = OptConfig(factored=factored, weight_decay=0.1)
    sched_args = ("cosine", 1e-3, 1, 10)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, jopt, lr_schedule=joptim.make_schedule(*sched_args),
        microbatches=case["microbatches"]))
    step = make_train_step(cfg, opt, lr_schedule=make_schedule(*sched_args),
                           microbatches=case["microbatches"])
    jstate, state = joptim.opt_init(tree, jopt), opt_init(lm, opt)
    before = flat(tree)
    for _ in range(2):
        tree, jstate, jm = jstep(tree, jstate, jbatch)
        lm, state, m = step(lm, state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    lr = float(make_schedule(*sched_args)(1))
    assert lr == pytest.approx(1e-3)
    got, want = flat(state), flat(jstate)
    assert got.keys() == want.keys()
    for path in want:
        scale = float(np.abs(want[path]).max())
        rtol = 2e-3 if path.split(".")[-1] in ("v", "vr", "vc") else 1e-3
        np.testing.assert_allclose(got[path], want[path], rtol=rtol,
                                   atol=1e-3 * scale, err_msg=path)
    moments = want
    got, want = flat(lm_params_to_tree(lm)), flat(tree)
    for path in want:
        g = np.abs(moments[f"leaves.{path}.m"])
        small = g < 1e-3 * g.max()
        np.testing.assert_allclose(got[path][~small], want[path][~small],
                                   rtol=1e-4, atol=1e-6, err_msg=path)
        assert np.all(np.abs(got[path][small] - before[path][small])
                      <= 2 * lr), path
        assert np.all(np.abs(got[path][small] - want[path][small])
                      <= lr / 8), path


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_train_step_opens_its_profiler_ranges(remat):
    """A CPU profile of one ``make_train_step`` step on zamba2-7b's smoke
    config (SSM layers and shared attention blocks) holds the step's
    ranges: ``mrsch.lm.adamw`` and ``mrsch.lm.logits_ce`` once each, one
    ``mrsch.lm.block`` per layer and one ``mrsch.lm.attention`` per use of
    a shared block, and with remat a second ``mrsch.lm.block`` per layer,
    opened by the backward's recompute (the shared blocks stay outside
    remat)."""
    from torch.profiler import ProfilerActivity, profile
    jcfg, cfg, tree, lm = reference("zamba2-7b")
    _, batch = batches(jcfg, cfg)
    opt = OptConfig()
    step = make_train_step(cfg, opt, remat=remat)
    state = opt_init(lm, opt)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(lm, state, batch)
    names = [e.name for e in prof.events() if e.name.startswith("mrsch.lm.")]
    uses = sum(seg is not None
               for _, seg, _ in transformer._hybrid_plan(cfg))
    assert uses >= 1
    assert {n: names.count(n) for n in set(names)} == {
        "mrsch.lm.adamw": 1, "mrsch.lm.logits_ce": 1,
        "mrsch.lm.block": cfg.n_layers * (2 if remat else 1),
        "mrsch.lm.attention": uses}


def test_train_loop_restart_resumes(tmp_path):
    """Kill-and-restart, as tests/test_checkpoint.py's: a second
    ``train_loop`` picks up at the checkpoint of step 4 and runs only the
    remaining steps."""
    r1 = _run("torch", 4, str(tmp_path), log_every=10)
    assert r1.restored_from is None and r1.steps == 4
    r2 = _run("torch", 8, str(tmp_path), log_every=10)
    assert r2.restored_from == 4
    assert r2.steps == 4


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_checkpoints_cross_packages(tmp_path, writer, reader):
    """One package's ``train_loop`` writes step 2 (two steps of the
    cosine schedule over 2 steps are the first two over 6: warmup 1, and
    step 1 at the peak either way); the other resumes from it to step 6.
    Its losses at steps 2-5 equal the writer's uninterrupted 6-step run
    within 2e-4, and the two packages' manifests list the same leaf
    paths, shapes and dtypes ({"params", "opt"} in the reference's
    stacked layout)."""
    first, resumed, whole = (str(tmp_path / d) for d in ("a", "a", "b"))
    _run(writer, 2, first)
    run = _run(reader, 6, resumed)
    assert run.restored_from == 2 and run.steps == 4
    ref = _run(writer, 6, whole)
    np.testing.assert_allclose(run.losses, ref.losses[2:], **LOSS_TOL)
    assert _manifest(first, 2) == _manifest(resumed, 6) \
        == _manifest(whole, 6)


SIGTERM_SCRIPT = """
import sys
sys.modules["jax"] = None         # the port trains without JAX
from repro_torch import configs
from repro_torch.launch.train import train_loop
run = train_loop(configs.smoke_config("stablelm-1.6b"),
                 configs.InputShape("t", 32, 2, "train"), steps=100000,
                 ckpt_dir=sys.argv[1], ckpt_every=100000, log_every=1,
                 device="cpu")
print("ended", run.steps, flush=True)
"""


def test_sigterm_flushes_a_checkpoint_and_ends_the_loop(tmp_path):
    """A SIGTERM to a process in ``train_loop`` (in a subprocess: the
    handler is the main thread's) makes it save at the next step boundary
    and leave the loop: the step it names is committed, long before the
    100,000 steps."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.Popen([sys.executable, "-c", SIGTERM_SCRIPT,
                             str(tmp_path)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        deadline = time.monotonic() + 120
        lines = []
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            assert line, proc.stderr.read()[-2000:]
            lines.append(line)
            if line.startswith("[train] step 2 "):
                break
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-2000:]
    lines += out.splitlines()
    preempted = [ln for ln in lines if "preempted at step" in ln]
    assert len(preempted) == 1, lines[-5:]
    step = int(preempted[0].split("preempted at step ")[1].split(";")[0])
    assert 3 <= step < 100000
    assert os.listdir(tmp_path) == [f"step_{step:08d}"]
    assert lines[-1].strip() == f"ended {step}"


def test_cli_prints_the_reference_json():
    """``python -m repro_torch.launch.train --arch stablelm-1.6b --smoke
    --steps 3 --device cpu``: the last line is the reference's JSON."""
    env = dict(os.environ, PYTHONPATH=SRC)
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", ARCH, "--smoke", "--steps", "3",
                        "--device", "cpu"], capture_output=True, text=True,
                       env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out.keys() == {"steps", "final_loss", "wall_s"}
    assert out["steps"] == 3 and np.isfinite(out["final_loss"])
