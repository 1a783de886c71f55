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
