"""Tests of the port that need an NVIDIA card (the CUDA kernels have no CPU
mode); they skip without one.  No jax here, so the file runs on a machine
with the card:  python -m pytest -q -m cuda tests/test_torch_cuda.py"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.fused_mlp import (ACTIVATIONS, fused_mlp,
                                           fused_mlp_layer_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(m, k, n, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return [torch.from_numpy(a).to(device=device, dtype=dtype)
            for a in (x, w, b)]


# Ragged N (not a multiple of 4: scalar loads; not of 128: masked tile),
# ragged M (37: three M tiles), K split and unsplit, the DFP shapes.
@pytest.mark.parametrize("m,k,n", [(1, 64, 32), (37, 300, 129),
                                   (16, 1000, 513), (3, 11410, 4000),
                                   (16, 4000, 1000), (8, 2, 128),
                                   (16, 512, 12), (5, 63, 7)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("act", ACTIVATIONS)
def test_kernel_matches_plain_version(cuda, m, k, n, dtype, tol, act):
    x, w, b = _inputs(m, k, n, seed=m + k + n, device=cuda, dtype=dtype)
    launches = fused_mlp.launches
    with torch.no_grad():
        out = fused_mlp(x, w, b, activation=act)
        ref = fused_mlp_layer_ref(x, w, b, act)
    torch.cuda.synchronize()
    assert fused_mlp.launches == launches + 1
    assert out.dtype == dtype and out.shape == (m, n)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def test_kernel_rows_do_not_depend_on_the_batch(cuda):
    """A row's result is the same alone or in a batch of up to 16 (same
    split, same summation order), so a served decision does not depend on
    which requests shared its batch."""
    x, w, b = _inputs(16, 11410, 4000, seed=0, device=cuda)
    with torch.no_grad():
        full = fused_mlp(x, w, b)
        for width in (1, 2, 4, 8):
            assert torch.equal(fused_mlp(x[:width].contiguous(), w, b),
                               full[:width])


# M > 16 runs the 64-row kernel (kernel.forward_plan): the DFP layers at
# ragged M around the device engine's and training's 64, and the attention
# encoder's token layers, at M up to 64 x 129.
FWD_SHAPES = [(11410, 4000), (4000, 1000), (1000, 512), (2, 128), (128, 128),
              (768, 512), (512, 12), (512, 120), (4, 64), (64, 64),
              (64, 128), (128, 64)]


@pytest.mark.parametrize("k,n", FWD_SHAPES)
@pytest.mark.parametrize("m", [17, 33, 63, 64, 65, 128, 8255, 8256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
def test_m64_kernel_matches_plain_version(cuda, m, k, n, dtype, tol):
    from repro_torch.kernels.fused_mlp import kernel
    assert kernel.forward_plan(m, k, n, 132)[0] == "fused_mlp_fwd_m64"
    act = ACTIVATIONS[(m + k + n) % len(ACTIVATIONS)]
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen, device=cuda).to(dtype)
    w = (torch.randn(k, n, generator=gen, device=cuda) / k ** 0.5).to(dtype)
    b = torch.randn(n, generator=gen, device=cuda).to(dtype)
    launches = fused_mlp.launches
    with torch.no_grad():
        out = fused_mlp(x, w, b, activation=act)
        ref = fused_mlp_layer_ref(x, w, b, act)
    torch.cuda.synchronize()
    assert fused_mlp.launches == launches + 1
    assert out.dtype == dtype and out.shape == (m, n)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("m,k,n", [(64, 11410, 4000), (65, 4000, 1000),
                                   (17, 1000, 512)])
def test_m64_kernel_repeats_bit_for_bit(cuda, m, k, n):
    """Two launches with a K split give the same bits: the splits' partial
    sums are added in a fixed order, not in the blocks' order."""
    from repro_torch.kernels.fused_mlp import kernel
    assert kernel.forward_plan(m, k, n, 132)[2] > 1
    x, w, b = _inputs(m, k, n, seed=m + n, device=cuda)
    with torch.no_grad():
        first = fused_mlp(x, w, b)
        for _ in range(3):
            assert torch.equal(fused_mlp(x, w, b), first)


def test_cuda_wrapper_rejects_and_never_falls_back(cuda):
    x, w, b = _inputs(4, 64, 32, seed=1, device=cuda)
    with torch.no_grad():
        with pytest.raises(ValueError, match="contiguous"):
            fused_mlp(x, w.t().contiguous().t(), b)
        with pytest.raises(ValueError, match="different devices"):
            fused_mlp(x, w.cpu(), b)
        with pytest.raises(TypeError, match="dtype"):
            fused_mlp(x.half(), w.half(), b.half())


def test_service_on_the_card_matches_plain_backend(cuda):
    """Small DFP on the card: the service (kernel backend) decides as the
    plain backend scores, wherever the top two values differ by more than
    the tolerance; each batch costs 13 launches."""
    from dataclasses import replace

    from repro_torch.core import AgentConfig, MRSchAgent
    from repro_torch.core.dfp import action_values
    from repro_torch.serve import DecisionService, ServeConfig
    from repro_torch.sim import Job, ResourceSpec, Simulator
    res = [ResourceSpec("node", 16), ResourceSpec("bb", 8)]
    agent = MRSchAgent(res, AgentConfig(state_hidden=(64, 32), state_out=16,
                                        module_hidden=8))
    assert agent.device.type == "cuda" and agent.dfp.backend == "kernel"
    rng = np.random.default_rng(0)
    jobs, t = [], 0.0
    for i in range(60):
        t += float(rng.exponential(20.0))
        rt = float(rng.uniform(20, 300))
        jobs.append(Job(i, t, rt, rt * 1.5, {"node": int(rng.integers(1, 12)),
                                             "bb": int(rng.integers(0, 6))}))
    rows, sim = [], Simulator(res, jobs, None)
    svc = DecisionService(agent, ServeConfig(max_batch=8))
    while (ctx := sim.next_decision()) is not None:
        rows.append(svc._encode(ctx))
        sim.post_action(len(rows) % len(ctx.window))
    launches = fused_mlp.launches
    with svc:
        served = [svc._batcher.submit(r).result(60.0) for r in rows]
    assert fused_mlp.launches - launches == 13 * (4 + len(rows))
    x = torch.from_numpy(np.stack(rows)).to(cuda)
    sd, m = agent.enc.state_dim, agent.enc.n_resources
    u = action_values(agent.net, replace(agent.dfp, backend="torch"),
                      x[:, :sd], x[:, sd:sd + m], x[:, sd + m:sd + 2 * m])
    u = torch.where(x[:, sd + 2 * m:] > 0.5, u, -torch.inf).cpu().numpy()
    top2 = np.sort(u, axis=1)[:, -2:]
    decisive = top2[:, 1] - top2[:, 0] > 2e-4 * max(1.0, np.abs(
        u[np.isfinite(u)]).max())
    assert decisive.sum() > len(rows) // 2
    assert (np.asarray(served)[decisive] == u.argmax(1)[decisive]).all()


# ------------------------------------------------------------ window pack
@pytest.mark.parametrize("n,j,f,w", [(1, 40, 4, 10), (3, 50, 7, 10),
                                     (64, 330, 4, 10), (8, 1000, 4, 64),
                                     (2, 1, 4, 10), (5, 33, 3, 10)])
@pytest.mark.parametrize("density", [0.0, 0.05, 0.4, 1.0])
def test_window_pack_kernel_matches_plain_version(cuda, n, j, f, w, density):
    from repro_torch.kernels.window_pack import (pack_window,
                                                 pack_window_reference)
    rng = np.random.default_rng(n * j + f)
    waiting = torch.from_numpy(
        (rng.uniform(size=(n, j)) < density).astype(np.float32)).to(cuda)
    feats = torch.from_numpy(
        rng.standard_normal((n, j, f)).astype(np.float32)).to(cuda)
    launches = pack_window.launches
    out = pack_window(waiting, feats, window=w)
    ref = pack_window_reference(waiting, feats, window=w)
    torch.cuda.synchronize()
    assert pack_window.launches == launches + 1
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_window_pack_rejects_and_never_falls_back(cuda):
    from repro_torch.kernels.window_pack import pack_window
    waiting = torch.ones(2, 8, device=cuda)
    feats = torch.ones(2, 8, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        pack_window(waiting, feats.transpose(0, 1).contiguous()
                    .transpose(0, 1), window=4)
    with pytest.raises(ValueError, match="different devices"):
        pack_window(waiting, feats.cpu(), window=4)
    with pytest.raises(TypeError, match="float32"):
        pack_window(waiting.double(), feats.double(), window=4)


# ------------------------------------------------------------ round front
# (mode, N, J, caps, enc_caps, W, K, drains): cells (c) and (f) at Theta's
# widths, then N up to 512 with drains, the encoding's sections above and
# below the capacity, K > J, three resources, a long job axis.
FRONT_GRID = [
    ("mlp", 64, 358, (4392, 1293), (4392, 1293), 10, 10, False),
    ("attention", 64, 445, (4392, 1293), (4392, 1293), 10, 128, False),
    ("mlp", 512, 300, (64, 32), (80, 16), 10, 10, True),
    ("attention", 512, 100, (64, 32), (64, 32), 10, 128, True),
    ("mask", 512, 700, (64, 32), (64, 32), 10, 10, True),
    ("mlp", 3, 40, (16, 8, 5), (12, 10, 5), 4, 4, True),
    ("attention", 5, 1000, (100,), (100,), 10, 16, False),
]


@pytest.mark.parametrize("mode,n,j,caps,enc_caps,w,k,drains", FRONT_GRID)
@pytest.mark.parametrize("density", [0.0, 0.05, 0.4, 1.0])
def test_decision_rows_kernel_matches_composite(cuda, mode, n, j, caps,
                                                enc_caps, w, k, drains,
                                                density):
    """The fused front against its plain composite on the card: bit for
    bit but the summed columns (goal, attention mean TTF), within
    atol 1e-6, rtol 1e-5 (sums in another order); one launch a call, and
    two calls equal bit for bit."""
    from _decision_rows import assert_same_front, decision_state, front_spec

    from repro_torch.kernels.window_pack import (pack_decision_rows,
                                                 pack_decision_rows_reference)
    ts = 3600.0 if mode == "attention" else 86400.0
    spec = front_spec(mode, caps, enc_caps, w, k, drains, ts)
    state = {name: None if v is None else torch.from_numpy(v).to(cuda)
             for name, v in decision_state(n, j, caps, density,
                                           drains=drains, seed=n + j,
                                           time_scale=ts).items()}
    launches = pack_decision_rows.launches
    out = pack_decision_rows(spec, **state)
    again = pack_decision_rows(spec, **state)
    ref = pack_decision_rows_reference(spec, **state)
    torch.cuda.synchronize()
    assert pack_decision_rows.launches == launches + 2
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert_same_front(spec, [t.cpu().numpy() for t in out],
                      [t.cpu().numpy() for t in ref])


def test_decision_rows_kernel_rejects_and_never_falls_back(cuda):
    from _decision_rows import decision_state, front_spec

    from repro_torch.kernels.window_pack import pack_decision_rows
    spec = front_spec("mlp", (16, 8), (16, 8), 10, 10, False)
    state = {name: None if v is None else torch.from_numpy(v).to(cuda)
             for name, v in decision_state(2, 20, (16, 8), 0.5).items()}
    launches = pack_decision_rows.launches
    for change, exc, match in [
            ({"feats": state["feats"].transpose(0, 1).contiguous()
              .transpose(0, 1)}, ValueError, "contiguous"),
            ({"release": state["release"].cpu()}, ValueError,
             "different devices"),
            ({"ready": state["ready"].double()}, TypeError, "ready must be"),
            ({"owner": torch.zeros(2, 24, dtype=torch.int32, device=cuda)},
             ValueError, "drains")]:
        with pytest.raises(exc, match=match):
            pack_decision_rows(spec, **{**state, **change})
    assert pack_decision_rows.launches == launches


# ------------------------------------------------------------ device engine
def test_device_rollout_on_the_card_matches_plain_backend(cuda):
    """A small agent's device rollout on the card: the kernel backend
    decides as the plain backend does, with one launch of the fused round
    front (and no standalone window pack) and 13 dense launches per
    deciding round."""
    from repro_torch.core import AgentConfig, MRSchAgent
    from repro_torch.kernels.window_pack import pack_decision_rows, pack_window
    from repro_torch.sim import DeviceSimulator, Job, ResourceSpec
    res = [ResourceSpec("node", 16), ResourceSpec("bb", 8)]
    agent = MRSchAgent(res, AgentConfig(state_hidden=(64, 32), state_out=16,
                                        module_hidden=8))
    rng = np.random.default_rng(1)
    jobsets = []
    for n in (30, 45, 60):
        jobs, t = [], 0.0
        for i in range(n):
            t += float(rng.exponential(30.0))
            rt = float(rng.uniform(20, 300))
            jobs.append(Job(i, t, rt, rt * 1.5,
                            {"node": int(rng.integers(1, 12)),
                             "bb": int(rng.integers(0, 6))}))
        jobsets.append(jobs)
    sim = DeviceSimulator(res, jobsets, agent)
    pack_window.launches = pack_decision_rows.launches = 0
    fused_mlp.launches = 0
    ro_k = sim.rollout()
    assert pack_decision_rows.launches == ro_k.stats.rounds > 0
    assert pack_window.launches == 0
    assert fused_mlp.launches == 13 * ro_k.stats.rounds
    agent.set_backend("torch")
    ro_t = sim.rollout()
    np.testing.assert_array_equal(ro_k.actions, ro_t.actions)
    for a, b in zip(ro_k.results, ro_t.results):
        assert a.metrics.as_row() == b.metrics.as_row()
        assert a.n_unstarted == 0


# ------------------------------------------------------------ gradients
# The DFP layer shapes (K, N), plus ragged ones (N not a multiple of 4 or of
# 128; K not a multiple of 4 or of 64).
BWD_SHAPES = [(11410, 4000), (4000, 1000), (1000, 512), (2, 128),
              (128, 128), (768, 512), (512, 12), (512, 120), (300, 129),
              (63, 7)]


@pytest.mark.parametrize("k,n", BWD_SHAPES)
@pytest.mark.parametrize("m", [1, 37, 64, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-3, 1e-4)),
                                       (torch.bfloat16, (2e-2, 2e-2))])
def test_gradient_kernels_match_plain_versions(cuda, m, k, n, dtype, tol):
    """dgrad and wgrad (dW and db) against their plain versions, all four
    activations, at the reference's gradient tolerance (bfloat16: 2e-2)."""
    from repro_torch.kernels.fused_mlp import (fused_mlp_dgrad,
                                               fused_mlp_dgrad_ref,
                                               fused_mlp_wgrad,
                                               fused_mlp_wgrad_ref)
    from repro_torch.kernels.fused_mlp.ref import apply_activation
    rng = np.random.default_rng(m + k + n)
    x, w, _ = _inputs(m, k, n, seed=m * k + n, device=cuda, dtype=dtype)
    g = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    pre = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    rtol, atol = tol
    for act in ACTIVATIONS:
        y = apply_activation(pre, act, 0.2).to(cuda, dtype)
        gd = g.to(cuda, dtype)
        launches = (fused_mlp_dgrad.launches, fused_mlp_wgrad.launches)
        dx = fused_mlp_dgrad(gd, y, w, activation=act)
        dw, db = fused_mlp_wgrad(x, gd, y, activation=act)
        torch.cuda.synchronize()
        assert (fused_mlp_dgrad.launches, fused_mlp_wgrad.launches) == \
            (launches[0] + 1, launches[1] + 1)
        assert dx.dtype == dw.dtype == db.dtype == dtype
        assert dx.shape == (m, k) and dw.shape == (k, n) and db.shape == (n,)
        torch.testing.assert_close(
            dx.float(), fused_mlp_dgrad_ref(gd, y, w, act).float(),
            rtol=rtol, atol=atol)
        ref_dw, ref_db = fused_mlp_wgrad_ref(x, gd, y, act)
        torch.testing.assert_close(dw.float(), ref_dw.float(), rtol=rtol,
                                   atol=atol)
        torch.testing.assert_close(db.float(), ref_db.float(), rtol=rtol,
                                   atol=atol)


# The dgrad's shapes (M, K, N) on the training paths: the MLP step's 10
# layers at M = 64 (the attention step's DFP heads among them) and the
# attention encoder's token layers at M = 8,256.
DGRAD_STEP_SHAPES = [(64, 4000, 1000), (64, 1000, 512), (64, 128, 128),
                     (64, 768, 512), (64, 512, 12), (64, 512, 120),
                     (8256, 64, 128), (8256, 128, 64), (8256, 64, 64)]


@pytest.mark.parametrize("m,k,n", DGRAD_STEP_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-3, 1e-4)),
                                       (torch.bfloat16, (2e-2, 2e-2))])
def test_dgrad_at_the_training_paths_shapes(cuda, m, k, n, dtype, tol):
    """B2, one launch a call (N split inside one cluster where the plan
    splits it), against its plain version at the reference's gradient
    tolerance, all four activations; two calls give the same bits."""
    from repro_torch.kernels.fused_mlp import (fused_mlp_dgrad,
                                               fused_mlp_dgrad_ref)
    from repro_torch.kernels.fused_mlp.ref import apply_activation
    rng = np.random.default_rng(m + k + n)
    w = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k))
                         .astype(np.float32)).to(cuda, dtype)
    g = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    pre = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    g = g.to(cuda, dtype)
    rtol, atol = tol
    for act in ACTIVATIONS:
        y = apply_activation(pre, act, 0.2).to(cuda, dtype)
        launches = fused_mlp_dgrad.launches
        dx = fused_mlp_dgrad(g, y, w, activation=act)
        again = fused_mlp_dgrad(g, y, w, activation=act)
        torch.cuda.synchronize()
        assert fused_mlp_dgrad.launches == launches + 2
        assert dx.dtype == dtype and dx.shape == (m, k)
        assert torch.equal(dx, again)
        torch.testing.assert_close(
            dx.float(), fused_mlp_dgrad_ref(g, y, w, act).float(),
            rtol=rtol, atol=atol)


# The attention encoder's token layers (K, N) at M up to 64 x 129: the
# wgrad splits M across blocks and adds the splits in a fixed order.
ENCODER_WGRAD = [(4, 64), (64, 64), (64, 128), (128, 64)]


@pytest.mark.parametrize("k,n", ENCODER_WGRAD)
@pytest.mark.parametrize("m", [8192, 8255, 8256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-3, 1e-4)),
                                       (torch.bfloat16, (2e-2, 2e-2))])
def test_wgrad_split_along_m_matches_plain_version(cuda, m, k, n, dtype,
                                                   tol):
    """dW and db at the encoder's shapes, where M is split, against the
    plain version, all four activations, at the reference's gradient
    tolerance (bfloat16: 2e-2)."""
    from repro_torch.kernels.fused_mlp import (fused_mlp_wgrad,
                                               fused_mlp_wgrad_ref, kernel)
    from repro_torch.kernels.fused_mlp.ref import apply_activation
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert kernel.wgrad_split_plan(m, k, n, sms)[0] > 1
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    pre = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    x, g = x.to(cuda, dtype), g.to(cuda, dtype)
    rtol, atol = tol
    for act in ACTIVATIONS:
        y = apply_activation(pre, act, 0.2).to(cuda, dtype)
        dw, db = fused_mlp_wgrad(x, g, y, activation=act)
        ref_dw, ref_db = fused_mlp_wgrad_ref(x, g, y, act)
        torch.cuda.synchronize()
        assert dw.dtype == db.dtype == dtype
        torch.testing.assert_close(dw.float(), ref_dw.float(), rtol=rtol,
                                   atol=atol)
        torch.testing.assert_close(db.float(), ref_db.float(), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("m,k,n", [(8256, 64, 64), (8192, 4, 64),
                                   (64, 11410, 4000), (64, 128, 128)])
def test_wgrad_repeats_bit_for_bit(cuda, m, k, n):
    """Two launches on the same inputs give the same bits: the splits'
    partial sums are added in a fixed order, not in the blocks' order."""
    from repro_torch.kernels.fused_mlp import fused_mlp_wgrad
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    x = torch.randn(m, k, generator=gen, device=cuda)
    g = torch.randn(m, n, generator=gen, device=cuda)
    y = torch.randn(m, n, generator=gen, device=cuda)
    first = fused_mlp_wgrad(x, g, y, activation="leaky_relu")
    for _ in range(3):
        again = fused_mlp_wgrad(x, g, y, activation="leaky_relu")
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_gradient_kernels_reject_and_never_fall_back(cuda):
    from repro_torch.kernels.fused_mlp import fused_mlp_dgrad, fused_mlp_wgrad
    g = torch.ones(4, 8, device=cuda)
    with pytest.raises(ValueError, match="different devices"):
        fused_mlp_dgrad(g, g, torch.ones(16, 8))
    with pytest.raises(ValueError, match="contiguous"):
        fused_mlp_wgrad(torch.ones(16, 4, device=cuda).t(), g, g)
    with pytest.raises(TypeError, match="dtype"):
        fused_mlp_wgrad(torch.ones(4, 16, device=cuda).half(), g.half(),
                        g.half())


def _small_trainer(**over):
    from repro_torch.core import AgentConfig, MRSchAgent
    from repro_torch.sim import ResourceSpec
    res = [ResourceSpec("node", 16), ResourceSpec("bb", 8)]
    cfg = AgentConfig(state_hidden=(64, 32), state_out=16, module_hidden=8,
                      stream_hidden=16, **over)
    return res, MRSchAgent(res, cfg)


def test_train_step_kernel_backend_matches_torch_backend(cuda):
    """One loss and its 26 gradient leaves from the same weights and batch:
    the kernel backend (13 forward, 10 dgrad, 13 wgrad launches) against
    autograd through plain ops."""
    from dataclasses import replace

    from repro_torch.convert import leaves
    from repro_torch.core.dfp import loss_fn
    from repro_torch.kernels.fused_mlp import fused_mlp_dgrad, fused_mlp_wgrad
    _, agent = _small_trainer()
    cfg = agent.dfp
    rng = np.random.default_rng(3)
    b, m, t = 64, cfg.n_measurements, cfg.n_offsets
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in {
        "state": rng.uniform(0, 1, (b, cfg.state_dim)).astype(np.float32),
        "meas": rng.uniform(0, 1, (b, m)).astype(np.float32),
        "goal": rng.dirichlet(np.ones(m), b).astype(np.float32),
        "action": rng.integers(0, cfg.n_actions, b).astype(np.int32),
        "target": rng.standard_normal((b, t, m)).astype(np.float32),
        "target_mask": (rng.uniform(size=(b, t)) < 0.7).astype(np.float32),
    }.items()}
    params = [p for _, p in leaves(agent.net)]
    fused_mlp.launches = fused_mlp_dgrad.launches = 0
    fused_mlp_wgrad.launches = 0
    loss_k = loss_fn(agent.net, cfg, batch)
    grads_k = torch.autograd.grad(loss_k, params)
    torch.cuda.synchronize()
    assert (fused_mlp.launches, fused_mlp_dgrad.launches,
            fused_mlp_wgrad.launches) == (13, 10, 13)
    loss_t = loss_fn(agent.net, replace(cfg, backend="torch"), batch)
    grads_t = torch.autograd.grad(loss_t, params)
    torch.testing.assert_close(loss_k, loss_t, rtol=1e-4, atol=0.0)
    for (name, _), gk, gt in zip(leaves(agent.net), grads_k, grads_t):
        torch.testing.assert_close(gk, gt, rtol=1e-3, atol=1e-4, msg=name)


def test_train_agent_on_the_card(cuda):
    """A few episodes of sequential training on the card: every train step
    runs 10 dgrad and 13 wgrad launches, losses are finite, weights move."""
    from repro_torch.core import train_agent
    from repro_torch.kernels.fused_mlp import fused_mlp_dgrad, fused_mlp_wgrad
    from repro_torch.sim import Job
    res, agent = _small_trainer(batch_size=16, grad_steps_per_episode=4)
    before = [p.detach().clone() for p in agent.net.parameters()]
    rng = np.random.default_rng(4)
    jobsets = []
    for n in (40, 50):
        jobs, t = [], 0.0
        for i in range(n):
            t += float(rng.exponential(30.0))
            rt = float(rng.uniform(20, 300))
            jobs.append(Job(i, t, rt, rt * 1.5,
                            {"node": int(rng.integers(1, 12)),
                             "bb": int(rng.integers(0, 6))}))
        jobsets.append(jobs)
    fused_mlp_dgrad.launches = fused_mlp_wgrad.launches = 0
    log = train_agent(agent, res, jobsets)
    steps = int(agent.opt_state.step)
    assert steps == 4 * len(log.episode_losses) > 0
    assert fused_mlp_dgrad.launches == 10 * steps
    assert fused_mlp_wgrad.launches == 13 * steps
    assert np.isfinite(log.episode_losses).all()
    assert np.isfinite(agent.last_grad_norm)
    assert all(not torch.equal(a, p) for a, p in zip(before,
                                                     agent.net.parameters()))


# ------------------------------------------------------- masked attention
# chip_smoke.py's grid: the main path's (4 x batch rows, 1 + Q = 129, 16)
# at batch 1, 8 and 64, and the other instantiated head dims; then the
# kernels' edges: one row, one and two 16-row warps, a single 8-key group
# short of 128, more rows than one block holds (257) and a tiled query
# side with a ring of key stages (600; at dh 64 a ring on both sides).
MHA_GRID = [(4, 129, 16), (32, 129, 16), (256, 129, 16), (8, 49, 8),
            (8, 257, 32), (8, 65, 64), (8, 1, 16), (8, 16, 8), (8, 17, 16),
            (8, 128, 16), (8, 257, 16), (8, 600, 16), (8, 600, 64)]


def _mha_case(bh, s, dh, seed, device):
    """q, k, v, do (BH, S, dh) and lengths 0, 1, S // 2, S, 15, 16, 17
    (the first BH of them), then random."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((bh, s, dh))
                                    .astype(np.float32)).to(device)
                   for _ in range(4))
    lens = rng.integers(0, s + 1, bh).astype(np.float32)
    head = np.asarray((0, 1, s // 2, s, 15, 16, 17), np.float32)[:bh]
    lens[:len(head)] = head
    return q, k, v, do, torch.from_numpy(lens).to(device)


@pytest.mark.parametrize("bh,s,dh", MHA_GRID)
def test_mha_kernels_match_plain_versions(cuda, bh, s, dh):
    """B5 and both B6 kernels against their plain versions on the same
    inputs, within 2e-5 (forward) and 1e-4 (backward) absolute; masked
    rows and keys exactly 0."""
    from repro_torch.kernels.flash_attention import (mha, mha_bwd_dkv,
                                                     mha_bwd_dq, mha_bwd_ref,
                                                     mha_fwd, mha_fwd_ref)
    q, k, v, do, lens = _mha_case(bh, s, dh, bh + s + dh, cuda)
    counts = (mha.launches, mha_bwd_dq.launches, mha_bwd_dkv.launches)
    o, lse = mha_fwd(q, k, v, lens)
    ro, rlse = mha_fwd_ref(q, k, v, lens)
    delta = (do * ro).sum(-1)
    grads = (mha_bwd_dq(q, k, v, do, rlse, delta, lens),
             *mha_bwd_dkv(q, k, v, do, rlse, delta, lens))
    refs = mha_bwd_ref(q, k, v, do, rlse, delta, lens)
    torch.cuda.synchronize()
    assert (mha.launches, mha_bwd_dq.launches, mha_bwd_dkv.launches) == \
        tuple(c + 1 for c in counts)
    torch.testing.assert_close(o, ro, rtol=0, atol=2e-5)
    valid = lens > 0
    torch.testing.assert_close(lse[valid], rlse[valid], rtol=0, atol=2e-5)
    assert torch.isfinite(lse).all() and (lse[~valid] < -1e29).all()
    assert torch.equal(o[~valid], torch.zeros_like(o[~valid]))
    for g, r in zip(grads, refs):
        assert g.shape == r.shape and torch.isfinite(g).all()
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4)
    kpos = torch.arange(s, device=cuda)[None, :] >= lens[:, None]
    for g in (grads[0][~valid], grads[1][kpos], grads[2][kpos]):
        assert torch.equal(g, torch.zeros_like(g))


def test_mha_kernels_repeat_bit_for_bit(cuda):
    """B5 and both B6 kernels at the main path's (256, 129, 16): two calls
    on the same inputs give the same bits (no atomics, a fixed order)."""
    from repro_torch.kernels.flash_attention import (mha_bwd_dkv, mha_bwd_dq,
                                                     mha_fwd)
    q, k, v, do, lens = _mha_case(256, 129, 16, 11, cuda)
    runs = []
    for _ in range(2):
        o, lse = mha_fwd(q, k, v, lens)
        delta = (do * o).sum(-1)
        runs.append((o, lse, mha_bwd_dq(q, k, v, do, lse, delta, lens),
                     *mha_bwd_dkv(q, k, v, do, lse, delta, lens)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_mha_fully_masked_is_exactly_zero_on_the_card(cuda):
    from repro_torch.kernels.flash_attention import mha
    q, k, v, _, _ = _mha_case(8, 65, 16, 3, cuda)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = mha(q, k, v, torch.zeros(8, device=cuda))
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    torch.cuda.synchronize()
    for t in (out, *grads):
        assert torch.isfinite(t).all() and torch.equal(t, torch.zeros_like(t))


def test_mha_wrapper_rejects_and_never_falls_back(cuda):
    from repro_torch.kernels.flash_attention import mha, mha_fwd
    q, k, v, _, lens = _mha_case(4, 33, 16, 4, cuda)
    with pytest.raises(ValueError, match="head dim"):
        mha(q[..., :12].contiguous(), k[..., :12].contiguous(),
            v[..., :12].contiguous(), lens)
    with pytest.raises(ValueError, match="contiguous"):
        mha(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, lens)
    with pytest.raises(ValueError, match="different devices"):
        mha(q, k.cpu(), v, lens)
    with pytest.raises(TypeError, match="float32"):
        mha_fwd(q.double(), k.double(), v.double(), lens)


def test_attention_train_step_kernel_backend_matches_torch_backend(cuda):
    """The attention state module's loss and 60 gradient leaves from the
    same weights and batch: the kernel backend (25 forward, 21 dgrad and 25
    wgrad fused-MLP launches, 2 of each attention kernel) against autograd
    through plain ops."""
    from dataclasses import replace

    from repro_torch.convert import leaves
    from repro_torch.core.dfp import loss_fn
    from repro_torch.kernels.flash_attention import (mha, mha_bwd_dkv,
                                                     mha_bwd_dq)
    from repro_torch.kernels.fused_mlp import fused_mlp_dgrad, fused_mlp_wgrad
    _, agent = _small_trainer(state_module="attention", queue_cap=24,
                              attn_dim=32, attn_heads=2)
    cfg = agent.dfp
    rng = np.random.default_rng(5)
    b, m, t, q, jd = 64, cfg.n_measurements, cfg.n_offsets, 24, 4
    state = rng.uniform(0, 1, (b, cfg.state_dim)).astype(np.float32)
    qlen = rng.integers(0, q + 1, b)
    for i, n in enumerate(qlen):
        state[i, n * jd:q * jd] = 0.0
    state[:, q * jd] = qlen
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in {
        "state": state,
        "meas": rng.uniform(0, 1, (b, m)).astype(np.float32),
        "goal": rng.dirichlet(np.ones(m), b).astype(np.float32),
        "action": rng.integers(0, cfg.n_actions, b).astype(np.int32),
        "target": rng.standard_normal((b, t, m)).astype(np.float32),
        "target_mask": (rng.uniform(size=(b, t)) < 0.7).astype(np.float32),
    }.items()}
    params = [p for _, p in leaves(agent.net)]
    counters = (fused_mlp, fused_mlp_dgrad, fused_mlp_wgrad, mha, mha_bwd_dq,
                mha_bwd_dkv)
    for c in counters:
        c.launches = 0
    loss_k = loss_fn(agent.net, cfg, batch)
    grads_k = torch.autograd.grad(loss_k, params)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [25, 21, 25, 2, 2, 2]
    loss_t = loss_fn(agent.net, replace(cfg, backend="torch"), batch)
    grads_t = torch.autograd.grad(loss_t, params)
    assert len(grads_k) == 60
    torch.testing.assert_close(loss_k, loss_t, rtol=1e-4, atol=0.0)
    for (name, _), gk, gt in zip(leaves(agent.net), grads_k, grads_t):
        torch.testing.assert_close(gk, gt, rtol=1e-3, atol=1e-4, msg=name)


# ------------------------------------------------ LM zoo: B7 (flash), B8 (ssd)
# The reference tests' grid (B, S, H, KV, dh), then every head dim the flash
# kernel is instantiated for, at a ragged S (not a multiple of 64).
FLASH_GRID = [(1, 128, 2, 2, 64), (2, 200, 4, 2, 64), (1, 384, 8, 1, 128),
              (2, 256, 6, 6, 32)] + [(1, 203, 4, 2, dh)
                                     for dh in (16, 32, 64, 112, 128, 192, 256)]
FLASH_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def _flash_case(b, sq, sk, h, kv, dh, dtype, seed, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device, dtype) for shape in ((b, sq, h, dh), (b, sk, kv, dh),
                                             (b, sk, kv, dh))]


@pytest.mark.parametrize("b,s,h,kv,dh", FLASH_GRID)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain_version(cuda, b, s, h, kv, dh, dtype,
                                            causal):
    """B7 against its plain version (rtol = atol = 2e-4 float32, 2e-2
    bfloat16, the reference's tolerances) and, in float32, against the
    dense ``attention_ref`` with the KV heads repeated."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention,
                                                     flash_attention_ref)
    q, k, v = _flash_case(b, s, s, h, kv, dh, dtype, s + h + dh, cuda)
    launches = flash_attention.launches
    by_kernel = dict(flash_attention.kernel_launches)
    out = flash_attention(q, k, v, causal=causal)
    ref = flash_attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    name = "flash_fwd" if dtype == torch.float32 else "flash_fwd_sm90"
    by_kernel[name] += 1
    assert flash_attention.kernel_launches == by_kernel
    assert out.dtype == dtype and out.shape == q.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if dtype == torch.float32:
        def flat(t):
            t = t.repeat_interleave(h // t.shape[2], dim=2)
            return t.transpose(1, 2).reshape(b * h, s, dh)
        dense = attention_ref(flat(q), flat(k), flat(v), causal=causal)
        torch.testing.assert_close(
            out.transpose(1, 2).reshape(b * h, s, dh), dense, rtol=tol,
            atol=tol)


def test_flash_float32_kernel_at_zamba2_7b_shape(cuda):
    """B7 in float32 (3xTF32 on mma.sync) at zamba2-7b's shared-attention
    shape, causal: 64 key tiles accumulate in the last rows, at the
    reference's 2e-4."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    q, k, v = _flash_case(1, 4096, 4096, 32, 32, 112, torch.float32, 7, cuda)
    out = flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, True),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("sq,sk", [(100, 260), (260, 100), (1, 300)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_with_unequal_lengths(cuda, sq, sk, causal):
    """Sq != Sk: keys masked past Sk, and the causal mask aligned top-left
    (query i sees keys j <= i), as in the reference."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    q, k, v = _flash_case(2, sq, sk, 4, 4, 64, torch.float32, sq + sk, cuda)
    out = flash_attention(q, k, v, causal=causal)
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, causal),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("sq,sk", [(100, 260), (260, 100), (1, 300)])
@pytest.mark.parametrize("dh", [64, 112, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bfloat16_kernel_with_unequal_lengths(cuda, sq, sk, dh,
                                                    causal):
    """The wgmma kernel with Sq != Sk and GQA: keys past Sk (zero-filled by
    TMA) masked, the causal mask top-left aligned, rows past Sq unwritten."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    q, k, v = _flash_case(2, sq, sk, 4, 2, dh, torch.bfloat16, sq + sk + dh,
                          cuda)
    out = flash_attention(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(),
                               flash_attention_ref(q, k, v, causal).float(),
                               rtol=2e-2, atol=2e-2)


def test_flash_wrapper_rejects_and_never_falls_back(cuda):
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _flash_case(1, 70, 70, 4, 2, 64, torch.float32, 0, cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(*(t[..., :48].contiguous() for t in (q, k, v)))
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="different devices"):
        flash_attention(q, k.cpu(), v)


def _ssd_case(b, s, h, p, n, g, dtype, seed, device):
    """The reference test's distributions: x normal, dt softplus(normal),
    dA = -dt exp(0.3 normal per head), B and C 0.3 normal (per group)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    dA = (-dt * np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    bm, cm = ((rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
              for _ in range(2))
    t = lambda a: torch.from_numpy(a).to(device)
    return t(x).to(dtype), t(dt), t(dA), t(bm).to(dtype), t(cm).to(dtype)


def _ssd_oracle(x, dt, dA, bm, cm):
    """``ssd_ref`` (the exact recurrence) in the models' layout, with the
    groups repeated per head."""
    from repro_torch.kernels.ssd import ssd_ref
    b, s, h, p = x.shape

    def flat(t):
        t = t.repeat_interleave(h // t.shape[2], dim=2) if t.dim() == 4 \
            else t[..., None]
        return t.transpose(1, 2).reshape(b * h, s, t.shape[-1])

    y = ssd_ref(flat(x), flat(dt), flat(dA), flat(bm), flat(cm))
    return y.reshape(b, h, s, p).transpose(1, 2)


# The reference tests' grid (B, S, H, P, N, chunk) with one group per head,
# then the LM configs' shapes at a ragged S: zamba2-7b (N 64) and
# mamba2-1.3b (N 128), one group over 4 heads.
SSD_GRID = [(1, 64, 2, 16, 8, 16, 2), (2, 100, 3, 16, 8, 32, 3),
            (1, 256, 4, 32, 16, 64, 4), (1, 600, 4, 64, 64, 256, 1),
            (1, 600, 4, 64, 128, 256, 1), (2, 4096, 112, 64, 64, 256, 1)]
SSD_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
# Float32 y against the plain chunked version, whatever x's dtype: the
# kernels' bfloat16 products take their float32 operands in three bfloat16
# parts and float32 ones run in 3xTF32, so they differ from the plain
# float32 arithmetic by more than the order of the sums, well inside this.
SSD_PLAIN_TOL = 1e-4


@pytest.mark.parametrize("b,s,h,p,n,chunk,g", SSD_GRID)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain_versions(cuda, b, s, h, p, n, chunk, g,
                                           dtype):
    """B8 in x's dtype against the exact recurrence ``ssd_ref`` (rtol =
    atol = 1e-3 float32, 5e-2 bfloat16, the reference's tolerances) and its
    plain chunked version, and with float32 y, as the models take it,
    against the plain chunked version (1e-4 for both dtypes); each call
    launches the three passes once, and two calls give the same bits."""
    from repro_torch.kernels.ssd import ssd, ssd_plain
    x, dt, dA, bm, cm = _ssd_case(b, s, h, p, n, g, dtype, s + n, cuda)
    launches = ssd.launches
    by_kernel = dict(ssd.kernel_launches)
    y = ssd(x, dt, dA, bm, cm, chunk=chunk)
    y32 = ssd(x, dt, dA, bm, cm, chunk=chunk, out_dtype=torch.float32)
    again = ssd(x, dt, dA, bm, cm, chunk=chunk, out_dtype=torch.float32)
    plain = ssd_plain(x, dt, dA, bm, cm, chunk=chunk,
                      out_dtype=torch.float32)
    oracle = _ssd_oracle(x, dt, dA, bm, cm)
    torch.cuda.synchronize()
    assert ssd.launches == launches + 3
    assert ssd.kernel_launches == {k: v + 3 for k, v in by_kernel.items()}
    assert y.dtype == dtype and y32.dtype == torch.float32
    assert torch.equal(y32, again)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), oracle.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(y.float(), plain, rtol=tol, atol=tol)
    torch.testing.assert_close(y32, plain, rtol=SSD_PLAIN_TOL,
                               atol=SSD_PLAIN_TOL)


def test_ssd_kernel_reads_strided_slices(cuda):
    """The model hands B8 slices of one fused projection (token stride
    larger than H * P): the result equals that of contiguous copies."""
    from repro_torch.kernels.ssd import ssd
    b, s, h, p, n = 2, 300, 4, 64, 64
    rng = np.random.default_rng(8)
    fused = torch.from_numpy(rng.standard_normal(
        (b, s, h * p + 2 * n)).astype(np.float32) * 0.3).to(cuda)
    x = fused[..., :h * p].reshape(b, s, h, p)
    bm = fused[..., h * p:h * p + n].reshape(b, s, 1, n)
    cm = fused[..., h * p + n:].reshape(b, s, 1, n)
    _, dt, dA, _, _ = _ssd_case(b, s, h, p, n, 1, torch.float32, 9, cuda)
    got = ssd(x, dt, dA, bm, cm, chunk=256)
    want = ssd(x.contiguous(), dt, dA, bm.contiguous(), cm.contiguous(),
               chunk=256)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_ssd_wrapper_rejects_and_never_falls_back(cuda):
    from repro_torch.kernels.ssd import ssd
    x, dt, dA, bm, cm = _ssd_case(1, 64, 2, 16, 8, 2, torch.float32, 1, cuda)
    with pytest.raises(ValueError, match="no kernel"):
        ssd(x[..., :8].contiguous(), dt, dA, bm, cm, chunk=16)
    with pytest.raises(ValueError, match="no kernel"):
        ssd(x, dt, dA, bm, cm, chunk=2048)
    with pytest.raises(TypeError, match="dtype"):
        ssd(x.half(), dt, dA, bm.half(), cm.half(), chunk=16)
    with pytest.raises(ValueError, match="stride"):
        ssd(x.transpose(2, 3).contiguous().transpose(2, 3), dt, dA, bm, cm,
            chunk=16)
    with pytest.raises(ValueError, match="different devices"):
        ssd(x, dt, dA, bm.cpu(), cm, chunk=16)


def test_b7_and_b8_refuse_a_graph(cuda):
    """B7 and B8 are forward-only, as in the reference: with grad mode on
    and an operand that requires grad, each wrapper raises before it
    launches, rather than return a result cut off from the graph; under
    ``torch.no_grad()`` the same call launches."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd import ssd
    q, k, v = _flash_case(1, 70, 70, 4, 2, 64, torch.float32, 0, cuda)
    x, dt, dA, bm, cm = _ssd_case(1, 64, 2, 16, 8, 2, torch.float32, 1, cuda)
    launches = (flash_attention.launches, ssd.launches)
    with pytest.raises(RuntimeError, match="B7 is forward-only"):
        flash_attention(q.requires_grad_(True), k, v)
    with pytest.raises(RuntimeError, match="B8 is forward-only"):
        ssd(x, dt.requires_grad_(True), dA, bm, cm, chunk=16)
    assert (flash_attention.launches, ssd.launches) == launches
    with torch.no_grad():
        flash_attention(q, k, v)
        ssd(x, dt, dA, bm, cm, chunk=16)
    assert (flash_attention.launches, ssd.launches) == (launches[0] + 1,
                                                        launches[1] + 1)


def test_lm_prefill_kernel_backend_matches_torch_backend(cuda):
    """A zamba2-7b smoke model (4 Mamba2 layers, 2 shared attention
    blocks) past the dense threshold (S = 2176 > 2048): the kernel backend
    launches B7 twice and B8 four times per forward and its last-token
    logits match the plain backend's within 1e-3."""
    from repro_torch.configs import smoke_config
    from repro_torch.data import make_batch
    from repro_torch.configs.shapes import InputShape
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd import ssd
    from repro_torch.launch import make_prefill_step
    from repro_torch.models import init_params
    cfg = smoke_config("zamba2-7b")
    params = init_params(cfg, generator=torch.Generator(cuda).manual_seed(1),
                         device=cuda, dtype=torch.float32)
    batch = make_batch(cfg, InputShape("t", 2176, 1, "prefill"), device=cuda)
    flash_attention.launches = ssd.launches = 0
    ssd.kernel_launches.update(dict.fromkeys(ssd.kernel_launches, 0))
    got = make_prefill_step(cfg)(params, batch)
    torch.cuda.synchronize()
    assert (flash_attention.launches, ssd.launches) == (2, 4)
    assert ssd.kernel_launches == dict.fromkeys(ssd.kernel_launches, 4)
    want = make_prefill_step(cfg, backend="torch")(params, batch)
    assert got.shape == (1, cfg.vocab_size) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
