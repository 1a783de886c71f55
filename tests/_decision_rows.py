"""Random round states for the tests of the device round's front
(``repro_torch.kernels.window_pack.pack_decision_rows``), made with numpy
from a seed; no jax here, so the card tests use them too."""
import numpy as np

from repro_torch.kernels.window_pack import DecisionRowSpec
from repro_torch.kernels.window_pack.ref import TTF_HORIZON

# The columns of spec.summed_columns (the goal, the attention context's
# mean TTF) are sums in another order in the reference's XLA ops, in
# PyTorch's CPU and CUDA ops and in the kernel: the same values up to
# float32 rounding of a sum of ~J or ~U terms, held within these.
SUMMED_ATOL, SUMMED_RTOL = 1e-6, 1e-5
FIELDS = ("waiting", "n_waiting", "free", "idx", "valid", "obs")


def assert_same_front(spec, mine, theirs):
    """Two fronts (six arrays each, numpy) equal bit for bit, except the
    summed columns of the rows, which agree within SUMMED_ATOL/RTOL."""
    summed = np.zeros(spec.row_dim, bool)
    summed[list(spec.summed_columns)] = True
    for name, a, b in zip(FIELDS, mine, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name == "obs":
            np.testing.assert_allclose(a[:, summed], b[:, summed],
                                       rtol=SUMMED_RTOL, atol=SUMMED_ATOL,
                                       err_msg="obs, summed columns")
            a, b = a[:, ~summed], b[:, ~summed]
        np.testing.assert_array_equal(a, b, err_msg=name)


def front_spec(mode, caps, enc_caps, w, k, drains, time_scale=86400.0):
    """The spec of a cluster with resources of capacities ``caps``."""
    offsets = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(int)
    return DecisionRowSpec(
        mode=mode, window=w, k=k,
        segments=tuple((int(o), int(c)) for o, c in zip(offsets, caps)),
        enc_caps=tuple(enc_caps), time_scale=time_scale, has_drains=drains)


def decision_state(n, j, caps, density, *, drains=False, seed=0,
                   time_scale=86400.0):
    """One round's state and the rollout's per-job arrays, as the device
    engine holds them: a job waits with probability ``density``, else it
    is not yet ready, running, finished or failed; units are free, busy
    (releases in the past, ahead and past the TTF horizon) and, with
    ``drains``, drained (phantom-owned, release +inf or a restore time).
    Row 0 has exactly three waiting jobs when any may wait."""
    rng = np.random.default_rng(seed)
    R, U = len(caps), int(sum(caps))
    f32 = np.float32
    now = rng.uniform(1e3, 2e5, n).astype(f32)
    kind = np.where(rng.uniform(size=(n, j)) < density, 0,
                    rng.integers(1, 5, (n, j)))
    if density > 0.0:
        kind[0] = np.where(np.arange(j) < 3, 0, np.maximum(kind[0], 1))
    past = rng.uniform(0.0, 1e4, (n, j))
    past[:, ::7] = 0.0                        # ready exactly at now
    ready = np.where(kind == 1, now[:, None] + 1.0 + past,
                     now[:, None] - past).astype(f32)
    ready[(kind == 1) & (rng.uniform(size=(n, j)) < 0.3)] = np.inf
    started = (kind == 2) | (kind == 3)
    finished = kind == 3
    failed = kind == 4
    est_end = np.where(started, now[:, None]
                       + rng.uniform(-3e3, 5e4, (n, j)), 0.0).astype(f32)
    walltime = rng.uniform(60.0, 2 * 86400.0, (n, j)).astype(f32)
    demands = np.stack([rng.integers(1 if r == 0 else 0, c + 1, (n, j))
                        for r, c in enumerate(caps)], axis=2).astype(f32)
    caps_f = np.asarray([max(c, 1) for c in caps], f32)
    fracs = (demands.astype(np.float64) / caps_f).astype(f32)
    submit = (ready.astype(np.float64)
              - rng.uniform(0.0, 500.0, (n, j))).astype(f32)
    submit[~np.isfinite(submit)] = 0.0
    feats = np.concatenate([fracs, (walltime / f32(time_scale))[..., None],
                            submit[..., None]], axis=2).astype(f32)
    u = rng.uniform(size=(n, U))
    release = np.where(u < 0.35, 0.0, now[:, None]
                       + rng.uniform(-2e3, 2e5, (n, U))).astype(f32)
    far = (u > 0.9) & (u < 0.95)
    release[far] = now[:, None].repeat(U, 1)[far] + f32(TTF_HORIZON * 1.5)
    owner = np.where(release == 0.0, -1,
                     rng.integers(0, j, (n, U))).astype(np.int32)
    if drains:
        drained = u > 0.95
        release[drained] = np.where(rng.uniform(size=drained.sum()) < 0.5,
                                    np.inf, 5e5).astype(f32)
        owner[drained] = -2
    return dict(ready=ready, now=now, started=started, finished=finished,
                failed=failed, release=release, est_end=est_end,
                owner=owner if drains else None, feats=feats,
                walltime=walltime, demands=demands, caps_f=caps_f)
