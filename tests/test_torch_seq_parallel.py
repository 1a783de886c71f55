"""The port's multi-card layer under sequence parallelism, on 8 spawned
gloo CPU ranks (``_torch_dist.seq_parallel``, one world for every case).

Under the "opt" and "serve" rule sets the residual stream's sequence is
sharded over "model" (act_seq) and so are the decode caches' positions
(kv_seq).  A train step of stablelm-1.6b and of mamba2-1.3b (smoke
configs) under each is held against the JAX package's single-device step
from the same weights at the tolerances of ``test_torch_sharded_train``,
and so is mamba2-1.3b's step under the baseline rules on a (2, 2, 2)
("pod", "data", "model") mesh, where a (pod, data) shard holds one row
of the batch.  The gradients of a backward run in a thread of its own
(as a card's autograd runs it) equal those of the calling thread's.  The
prefill step's last logits under both rule sets, and two "serve" decode
steps over a cache whose positions are split across the "model" ranks
(the first step writes the slot the second reads), are held against the
JAX package's forward and decode step on the same weights and inputs at
``MODEL_TOL``, and against the no-mesh port at ``SHARD_TOL``, in
float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from repro.configs import smoke_config as jsmoke
from repro.models import transformer as jtransformer
from repro_torch.configs import smoke_config
from repro_torch.convert import _flatten, nest
from repro_torch.launch import make_decode_step, make_prefill_step
from repro_torch.models import transformer
from test_torch_lm_decode import MODEL_TOL, _cache_leaves, _model
from test_torch_sharded_train import (check_loss, check_moments,
                                      check_parameters, reference_step)

TRAIN_ARCHS = ("stablelm-1.6b", "mamba2-1.3b")
SEQ_RULES = ("opt", "serve")
DECODE_ARCHS = ("stablelm-1.6b", "deepseek-v2-lite-16b")
# The sharded step against the no-mesh one: float32 sums taken in another
# order (split over ranks, then added), a few ulps of the largest value.
SHARD_TOL = dict(rtol=1e-5, atol=1e-5)
CACHE_LEN, POS, STEPS, DECODE_B = 64, 37, 2, 2


@pytest.fixture(scope="module")
def refs():
    return {arch: reference_step(arch) for arch in TRAIN_ARCHS}


def flat_cache(tree) -> dict:
    out = {}
    _flatten(tree, "", out, leaf=lambda x: x.numpy())
    return out


def nest_cache(flat: dict):
    return nest({k: torch.from_numpy(v.copy()) for k, v in flat.items()})


def decode_case(arch: str) -> dict:
    """The reference's weights (seed 0, and the port's by ``convert``),
    tokens, and a cache filled with normal numbers at the positions before
    ``POS``; the no-mesh port's and the reference's logits and caches
    after ``STEPS`` decode steps from there (caches by ``_cache_leaves``
    name)."""
    jcfg, cfg, tree, lm = _model(arch)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (DECODE_B, STEPS))
    cache = {}
    for path, t in flat_cache(transformer.init_cache(
            cfg, DECODE_B, CACHE_LEN, torch.float32, device="cpu")).items():
        a = np.zeros(t.shape, np.float32)
        a[:, :, :POS] = rng.standard_normal(a[:, :, :POS].shape)
        cache[path] = a
    by_name = {k: v.numpy() for k, v in _cache_leaves(
        nest_cache(cache)).items()}
    jcache = jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(by_name["/".join(
            str(getattr(k, "key", k)) for k in path)]),
        jtransformer.init_cache(jcfg, DECODE_B, CACHE_LEN, jnp.float32))
    step = make_decode_step(cfg)
    jstep = jax.jit(lambda p, b, c, pos: jtransformer.decode_step(
        p, jcfg, b, c, pos))
    tcache, logits, jlogits = nest_cache(cache), [], []
    for i in range(STEPS):
        got, tcache = step(lm, {"tokens": torch.from_numpy(tokens[:, i:i + 1])},
                           tcache, POS + i)
        logits.append(got.numpy())
        want, jcache = jstep(tree, {"tokens": jnp.asarray(
            tokens[:, i:i + 1], jnp.int32)}, jcache, POS + i)
        jlogits.append(np.asarray(want[:, -1]))
    return {"inputs": (tokens, cache, POS, _torch_dist.as_numpy_state(lm)),
            "logits": logits, "cache": flat_cache(tcache),
            "jax_logits": jlogits,
            "jax_cache": {k: np.asarray(v)
                          for k, v in _cache_leaves(jcache).items()}}


@pytest.fixture(scope="module")
def decodes():
    return {arch: decode_case(arch) for arch in DECODE_ARCHS}


@pytest.fixture(scope="module")
def ranks(refs, decodes, tmp_path_factory):
    return _torch_dist.run_ranks(
        _torch_dist.seq_parallel, tmp_path_factory.mktemp("seq"),
        {a: (r["batch"], r["state"]) for a, r in refs.items()},
        {a: (r["batch"]["tokens"], r["state"]) for a, r in refs.items()},
        {a: d["inputs"] for a, d in decodes.items()})


TRAIN_CASES = [(a, r) for a in TRAIN_ARCHS for r in SEQ_RULES] + [
    ("mamba2-1.3b", "pod")]


@pytest.mark.parametrize("arch,rules", TRAIN_CASES)
def test_seq_parallel_step_loss_matches_single_device(ranks, refs, arch,
                                                      rules):
    check_loss(ranks["train", arch, rules], refs[arch]["m1"])


@pytest.mark.parametrize("arch,rules", TRAIN_CASES)
def test_seq_parallel_step_parameters_match_single_device(ranks, refs, arch,
                                                          rules):
    ref = refs[arch]
    check_parameters(ranks["train", arch, rules], ref["want"], ref["state"],
                     ref["moments"])


@pytest.mark.parametrize("arch,rules", TRAIN_CASES)
def test_seq_parallel_step_moments_match_single_device(ranks, refs, arch,
                                                       rules):
    """Every gradient leaf, through the all-gather of the sequence before
    each column-parallel product and its reduce-scatter backward."""
    check_moments(ranks["train", arch, rules]["opt"], refs[arch]["moments"])


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_backward_in_another_thread_matches_the_calling_threads(ranks,
                                                                arch):
    """A card's backward runs in autograd's device thread, outside the
    forward's rules and (torch 2.13) its implicit replication: no plain
    tensor may reach a DTensor op there (rope's angles did)."""
    got = ranks["thread", arch, "opt"]
    assert not isinstance(got["thread"], str), got["thread"]
    assert got["thread"].keys() == got["here"].keys()
    for name, want in got["here"].items():
        np.testing.assert_array_equal(got["thread"][name], want,
                                      err_msg=name)


def plain_prefill(arch: str, ref: dict) -> np.ndarray:
    cfg = smoke_config(arch)
    lm = transformer.LM(cfg, torch.float32, "cpu")
    lm.load_state_dict({k: torch.from_numpy(v) for k, v in ref["state"].items()})
    step = make_prefill_step(cfg, backend="torch")
    return step(lm, {"tokens": torch.from_numpy(ref["batch"]["tokens"])}
                ).numpy()


def jax_prefill(arch: str, ref: dict) -> np.ndarray:
    tokens = jnp.asarray(ref["batch"]["tokens"], jnp.int32)
    return np.asarray(jax.jit(lambda p, t: jtransformer.forward(
        p, jsmoke(arch), {"tokens": t})[:, -1])(ref["jparams"], tokens))


@pytest.mark.parametrize("arch,rules", [(a, r) for a in TRAIN_ARCHS
                                        for r in SEQ_RULES])
def test_seq_parallel_prefill_matches_no_mesh(ranks, refs, arch, rules):
    """The last logits against the reference's forward, and against the
    no-mesh port's prefill step."""
    got = ranks["prefill", arch, rules]
    want = jax_prefill(arch, refs[arch])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **MODEL_TOL)
    np.testing.assert_allclose(got, plain_prefill(arch, refs[arch]),
                               **SHARD_TOL)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_serve_decode_over_a_sequence_sharded_cache(ranks, decodes, arch):
    """Each step's logits and every cache leaf after both steps against
    the reference's decode step and against the no-mesh port's (the token
    written into the rank that holds its position, and nowhere else)."""
    got, want = ranks["decode", arch, "serve"], decodes[arch]
    for g, w, j in zip(got["logits"], want["logits"], want["jax_logits"]):
        np.testing.assert_allclose(g, j, **MODEL_TOL)
        np.testing.assert_allclose(g, w, **SHARD_TOL)
    assert got["cache"].keys() == want["cache"].keys()
    by_name = {k: v.numpy() for k, v in _cache_leaves(
        nest_cache(got["cache"])).items()}
    assert by_name.keys() == want["jax_cache"].keys()
    for path, w in want["jax_cache"].items():
        np.testing.assert_allclose(by_name[path], w, **MODEL_TOL,
                                   err_msg=path)
    for path, w in want["cache"].items():
        np.testing.assert_allclose(got["cache"][path], w, **SHARD_TOL,
                                   err_msg=path)
