"""The port's MoE layer and the MoE / dense GQA configs against the JAX
reference, on the CPU.

Inputs are made with numpy from a seed, weights go through
``repro_torch.bridge.from_numpy_tree``. ``moe_forward`` rounds nowhere
but in its own type, so it is held at the tolerances of
``tests/test_kernels.py``: float32 2e-5, bfloat16 3e-2. Whole-model logits
pass through ``blockwise_attention``, which rounds q, k, v and the
probabilities to bfloat16 in both packages (a one-ulp float32 difference
upstream can flip a rounding, 2**-8 relative), so they are held at 1e-2 in
the worst element and 1e-4 in the median, as ``tests/test_torch_layers.py``
holds them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import Model as JaxModel
from repro.models import moe as jmoe
from repro.models.transformer import stack_plan as jax_stack_plan

from repro_torch.bridge import from_numpy_tree, init_params, to_numpy_tree
from repro_torch.configs import ARCH_IDS, ArchConfig, get_config, \
    reference_fields, smoke_config
from repro_torch.models import moe
from repro_torch.models.transformer import Model, stack_plan

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
LLAMA4 = "llama4-scout-17b-a16e"
NEW_ARCHS = ["paper-opt-13b", "granite-20b", "command-r-35b",
             "mistral-large-123b", LLAMA4]


def _np(x):
    return np.asarray(x, np.float32)


def _port_cfg(jcfg):
    return ArchConfig(**dataclasses.asdict(jcfg))


def _moe_case(dtype, seed=0, **kw):
    """A smoke llama4 MoE layer (4 experts, d 256, ff 128) in ``dtype``:
    the JAX config and params, the port's, and x (2, 24, 256)."""
    jcfg = dataclasses.replace(jax_smoke_config(LLAMA4), dtype=dtype, **kw)
    p = jmoe.moe_init(jcfg, jax.random.PRNGKey(seed), jcfg.param_dtype)
    x = np.random.default_rng(seed).standard_normal((2, 24, 256)) \
        .astype(np.float32)
    jx = jnp.asarray(x, jcfg.param_dtype)
    tx = from_numpy_tree(np.asarray(jx))
    return jcfg, p, jx, _port_cfg(jcfg), \
        from_numpy_tree(jax.tree.map(np.asarray, p)), tx


def _check_moe(jcfg, p, jx, tcfg, tp, tx):
    want, want_aux = jmoe.moe_forward(jcfg, p, jx, return_aux=True)
    got, aux = moe.moe_forward(tcfg, tp, tx, return_aux=True)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got.float()), _np(want),
                               **TOL[jcfg.dtype])
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=2e-5)


def _places(tcfg, tp, tx):
    """(top-k experts, places) of each token, as moe_forward assigns
    them."""
    t = tx.shape[0] * tx.shape[1]
    probs = torch.softmax(tx.reshape(t, -1).float() @ tp["router"]["w"], -1)
    topi = torch.sort(probs, dim=-1, descending=True,
                      stable=True)[1][:, :tcfg.moe_top_k]
    oh = torch.nn.functional.one_hot(topi.reshape(-1), tcfg.num_experts)
    return topi, ((oh.cumsum(0) - oh) * oh).sum(-1).view(t, -1)


# -- moe_forward ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_forward_matches_jax(top_k, shared, dtype):
    """Output and aux loss, top-1 and top-2, with and without a shared
    expert, at the smoke capacity (factor 4: nothing dropped)."""
    _check_moe(*_moe_case(dtype, moe_top_k=top_k, num_shared_experts=shared))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_forward_drops_past_capacity(top_k, dtype):
    """capacity_factor 0.5: places at or past the capacity are dropped, in
    the reference's token-major, choice-minor order."""
    case = _moe_case(dtype, seed=1, moe_top_k=top_k, capacity_factor=0.5)
    tcfg, tp, tx = case[3:]
    _, pos = _places(tcfg, tp, tx)
    cap = moe.capacity(tcfg, 48)
    assert (pos >= cap).any() and (pos < cap).any(), (cap, pos.max())
    _check_moe(*case)


@pytest.mark.parametrize("capacity_tokens", [None, 64, 512])
@pytest.mark.parametrize("factor", [4.0, 0.5])
def test_fitted_capacity_keeps_the_same_places(factor, capacity_tokens):
    """``fit_capacity`` (a serving chunk's MoE): the capacity cut to the
    fullest expert's places, where they fit in less, keeps and drops the
    same (token, choice)s as the static capacity, at factor 4 (nothing
    dropped) and 0.5 (drops, where the static capacity stands), so the
    output is the static capacity's at the file's float32 tolerance (the
    expert products run over fewer rows)."""
    tcfg, tp, tx = _moe_case("float32", seed=2, capacity_factor=factor)[3:]
    want = moe.moe_forward(tcfg, tp, tx, capacity_tokens=capacity_tokens)
    got = moe.moe_forward(tcfg, tp, tx, capacity_tokens=capacity_tokens,
                          fit_capacity=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


class _Groups:
    """A policy of ``g`` MoE groups and nothing else, for either package
    (no ``moe_apply``: the grouped dispatch runs)."""

    def __init__(self, g):
        self.moe_groups = g

    def act(self, x, kind):
        return x

    def param(self, w, kind):
        return w


class _PortGroups(moe.ShardingPolicy):
    def __init__(self, g):
        self.moe_groups = g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 2, 3, 5])
def test_grouped_moe_forward_matches_jax(groups, dtype):
    """GShard's grouped dispatch at G groups (a mesh's data shards) against
    the JAX ``moe_forward`` at the same G, at capacity factor 0.5: each
    group fills its own capacity, so drops differ from one group's (G 2
    checked to differ); G 5 does not divide the 48 tokens and falls back
    to one group in both."""
    jcfg, p, jx, tcfg, tp, tx = _moe_case(dtype, seed=2, moe_top_k=2,
                                          capacity_factor=0.5)
    want, want_aux = jmoe.moe_forward(jcfg, p, jx, policy=_Groups(groups),
                                      return_aux=True)
    got, aux = moe.moe_forward(tcfg, tp, tx, policy=_PortGroups(groups),
                               return_aux=True)
    np.testing.assert_allclose(_np(got.float()), _np(want),
                               **TOL[jcfg.dtype])
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=2e-5)
    if groups == 2:
        one = moe.moe_forward(tcfg, tp, tx)
        assert not torch.equal(one, got)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_forward_breaks_ties_by_index(top_k):
    """Router columns 1-3 built equal, so those experts' probabilities tie
    exactly: ``lax.top_k`` takes the lower index first, and so must the
    port (``torch.topk`` does not promise it). At capacity factor 0.5 the
    tie's winner also decides which tokens are dropped."""
    jcfg, p, jx, tcfg, tp, tx = _moe_case("float32", seed=2,
                                          moe_top_k=top_k,
                                          capacity_factor=0.5)
    w = np.asarray(p["router"]["w"]).copy()
    w[:, 2] = w[:, 3] = w[:, 1]
    p = dict(p, router={"w": jnp.asarray(w)})
    tp = dict(tp, router={"w": torch.from_numpy(w)})
    topi, _ = _places(tcfg, tp, tx)
    # the tied experts: 1 wins over 2 and 3, and 2 is the runner-up
    assert not (topi[:, 0] > 1).any()
    if top_k == 2:
        assert ((topi[:, 0] == 1) & (topi[:, 1] == 2)).any()
    _check_moe(jcfg, p, jx, tcfg, tp, tx)


@pytest.mark.parametrize("tokens", [1, 16, 24, 70, 128, 300, 512])
def test_capacity_matches_reference(tokens):
    for factor in (1.0, 1.25, 4.0):
        jcfg = dataclasses.replace(jax_get_config(LLAMA4),
                                   capacity_factor=factor)
        assert moe.capacity(_port_cfg(jcfg), tokens) == \
            jmoe.capacity(jcfg, tokens)


# -- configs, plans and the weights -------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_and_smoke_config_match_reference(arch):
    """Field for field, full and reduced (the MoE branch keeps 4 experts,
    top-k <= 2, ff 128, <= 1 shared expert, capacity factor 4)."""
    assert reference_fields(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))
    assert reference_fields(smoke_config(arch)) == \
        dataclasses.asdict(jax_smoke_config(arch))


@pytest.mark.parametrize("arch,first_k_dense",
                         [(a, 0) for a in NEW_ARCHS] + [(LLAMA4, 1)])
def test_stack_plan_matches_reference(arch, first_k_dense):
    """A MoE plan is ``first_k_dense`` dense layers, then the MoE
    segment."""
    cfg = dataclasses.replace(get_config(arch), first_k_dense=first_k_dense)
    want = [(s.n, s.mixer, s.mlp_kind, s.attn_kind)
            for s in jax_stack_plan(cfg)]
    assert [(s.n, s.mixer, s.mlp_kind, s.attn_kind)
            for s in stack_plan(cfg)] == want


def test_init_params_moe_tree_matches_reference():
    """The port's MoE weights: the reference's tree and shapes, a float32
    router, and its distributions."""
    jcfg = dataclasses.replace(jax_smoke_config(LLAMA4), first_k_dense=1,
                               num_layers=3)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(0))
    tparams = init_params(_port_cfg(jcfg), seed=0, device="cpu")
    ja = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tb = jax.tree_util.tree_flatten_with_path(to_numpy_tree(tparams))[0]
    assert [p for p, _ in ja] == [p for p, _ in tb]
    for (_, a), (_, b) in zip(ja, tb):
        assert a.shape == b.shape
    m = tparams["segments"][1]["mlp"]
    assert m["router"]["w"].dtype == torch.float32
    assert m["gate"].dtype == torch.bfloat16
    assert abs(m["router"]["w"].std().item() * 16 - 1.0) < 0.05
    assert abs(m["up"].float().std().item() * 16 - 1.0) < 0.05
    assert abs(m["down"].float().std().item() * np.sqrt(128) - 1.0) < 0.05
    assert abs(m["shared"]["gate"]["w"].float().std().item() * 16 - 1.0) \
        < 0.05


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normal_init_draws_large_tensors_in_slices(monkeypatch, dtype):
    """A tensor above NORMAL_CHUNK elements is drawn slice by slice into
    its own type: same shape and type, the scale's spread, no slice left
    undrawn, and the seed decides every value."""
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "NORMAL_CHUNK", 1000)

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return layers.normal_init(gen, (3, 50, 41), 0.5, dtype, "cpu")

    w = draw(0)
    assert w.shape == (3, 50, 41) and w.dtype == dtype
    assert abs(w.float().std().item() - 0.5) < 0.02
    flat = w.float().reshape(-1)
    for i in range(0, flat.numel(), 1000):  # every slice a draw of its own
        assert 0.4 < flat[i:i + 1000].std().item() < 0.6
    assert torch.equal(w, draw(0)) and not torch.equal(w, draw(1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normal_init_small_tensor_is_one_draw(dtype):
    """A tensor of at most NORMAL_CHUNK elements is one float32 draw of its
    shape, scaled, then cast: the values of ``randn(shape) * scale``."""
    from repro_torch.models import layers
    w = layers.normal_init(torch.Generator().manual_seed(3), (7, 33), 0.25,
                           dtype, "cpu")
    want = torch.randn((7, 33), generator=torch.Generator().manual_seed(3))
    assert torch.equal(w, (want * 0.25).to(dtype))


@pytest.mark.parametrize("first_k_dense,factor", [(0, 4.0), (0, 1.0),
                                                  (1, 0.5)])
def test_llama4_model_forward_matches_jax(first_k_dense, factor):
    """Smoke llama4 teacher-forced logits and the summed aux loss, float32,
    with and without dropped tokens, and with a leading dense layer (a
    one-layer segment before the MoE segment)."""
    jcfg = dataclasses.replace(jax_smoke_config(LLAMA4), dtype="float32",
                               logits_fp32=True, capacity_factor=factor,
                               first_k_dense=first_k_dense)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(1))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams))
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 60))
    want, want_aux = JaxModel(jcfg, remat=False).forward(jparams,
                                                         jnp.asarray(toks))
    got, aux = Model(_port_cfg(jcfg)).forward(tparams, torch.from_numpy(toks))
    assert got.shape == (2, 60, 512)
    d = np.abs(_np(got) - _np(want))
    assert d.max() <= 1e-2 and np.median(d) <= 1e-4, (d.max(), np.median(d))
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))
    assert float(want_aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=2e-5)
