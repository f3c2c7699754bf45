"""The port's training loss and its gradients against the JAX package, on
the CPU: ``ssd_chunked`` (the differentiable SSD scan of the loss path),
``Model.loss`` and the gradient of every parameter for one model of each
plan family at smoke size in float32, and ``remat`` (each layer under
``torch.utils.checkpoint``) against no remat.

The same weights (a JAX ``Model.init`` tree, carried over by the bridge)
and the same inputs (numpy, from a seed) go through both packages. The
loss is held at 2e-5 relative. A gradient is held by its error relative to
the leaf's largest |g|: 1e-2 in the worst element and 2e-3 in the median,
because both packages round q, k, v, the probabilities and their
cotangents to bfloat16 in ``blockwise_attention``, so a one-ulp float32
difference upstream can flip a rounding (2**-8 relative). The largest
worst error seen was 5.1e-3 (seamless's cross-attention keys) and the
largest median 6.1e-4 (deepseek-v2's MLA). One leaf has a zero gradient in
exact arithmetic: the cross-attention key bias (its keys are not roped, so
the bias shifts every score of a query alike and the softmax ignores it).
Both packages' gradients there are rounding noise; each must stay below
1e-4 of the tree's largest |g|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import Model as JaxModel
from repro.models import ssm as jssm

from repro_torch.bridge import from_numpy_tree
from repro_torch.configs import ArchConfig
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import Model
from repro_torch.training.tree import leaves, unflatten

# one arch of each plan family: sliding window, MoE (and its aux loss),
# MLA with MoE, SSM, hybrid, encoder-decoder, media
FAMILIES = ["h2o-danube-1.8b", "llama4-scout-17b-a16e", "deepseek-v2-236b",
            "mamba2-1.3b", "hymba-1.5b", "seamless-m4t-medium",
            "internvl2-26b"]
B, S, ENC = 2, 64, 40
LOSS_RTOL = 2e-5
GRAD_WORST, GRAD_MEDIAN = 1e-2, 2e-3
ZERO_GRAD_LEAVES = ("['cross']['wk']['b']",)
ZERO_GRAD_LIMIT = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one CPU thread: beside other test processes a threaded BLAS
    oversubscribes the cores (a run took 25x longer), and may split a
    product otherwise from call to call, which changes roundings that the
    remat test compares bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed):
    """tokens and labels (B, S), the first labels of row 0 masked (-1);
    media (B, M, D) normal x 0.02 and encoder tokens (B, ENC) where the
    config takes them. numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = toks.copy()
    labels[0, :5] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.num_media_tokens:
        batch["media"] = (rng.standard_normal(
            (B, cfg.num_media_tokens, cfg.d_model)) * 0.02) \
            .astype(np.float32)
    if cfg.is_encdec:
        batch["encoder_tokens"] = rng.integers(
            0, cfg.vocab_size, (B, ENC)).astype(np.int32)
    return batch


def _setup(arch, **updates):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               logits_fp32=True, **updates)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(0))
    return jcfg, jparams, ArchConfig(**dataclasses.asdict(jcfg)), \
        from_numpy_tree(jax.tree.map(np.asarray, jparams))


def _torch_loss_and_grads(model, params, batch):
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss = model.loss(unflatten(params, flat),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return loss.detach(), [p.grad for p in flat]


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_every_gradient_match_jax(arch):
    jcfg, jparams, tcfg, tparams = _setup(arch)
    batch = _batch(jcfg, seed=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        JaxModel(jcfg, remat=False).loss))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrads = _torch_loss_and_grads(Model(tcfg), tparams, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)

    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    jleaves = [np.asarray(g) for g in jax.tree.leaves(jgrads)]
    assert len(tgrads) == len(jleaves)
    top = max(float(np.abs(g).max()) for g in jleaves)
    for path, t, j in zip(paths, tgrads, jleaves):
        assert t is not None, path
        t = t.numpy()
        assert t.shape == j.shape and t.dtype == j.dtype, path
        if path.endswith(ZERO_GRAD_LEAVES):
            assert np.abs(t).max() <= ZERO_GRAD_LIMIT * top, path
            assert np.abs(j).max() <= ZERO_GRAD_LIMIT * top, path
            continue
        d = np.abs(t - j) / max(float(np.abs(j).max()), 1e-30)
        assert d.max() <= GRAD_WORST and np.median(d) <= GRAD_MEDIAN, \
            (path, float(d.max()), float(np.median(d)))


@pytest.mark.parametrize("arch,layers", [("h2o-danube-1.8b", 3),
                                         ("llama4-scout-17b-a16e", 2),
                                         ("hymba-1.5b", 4),
                                         ("seamless-m4t-medium", 2)])
def test_remat_gives_equal_loss_and_gradients(arch, layers):
    """Recomputing each layer in the backward changes nothing, bit for
    bit: the MoE aux loss comes back from the layer (no closure that a
    recomputation would run twice); hymba at 4 layers has a stacked
    3-layer segment."""
    jcfg, _, tcfg, tparams = _setup(arch, num_layers=layers)
    batch = _batch(jcfg, seed=2)
    loss0, g0 = _torch_loss_and_grads(Model(tcfg, remat=False), tparams,
                                      batch)
    loss1, g1 = _torch_loss_and_grads(Model(tcfg, remat=True), tparams,
                                      batch)
    assert torch.equal(loss0, loss1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_forward_is_gradient_free_and_loss_is_not():
    _, _, tcfg, tparams = _setup("h2o-danube-1.8b")
    model = Model(tcfg)
    flat = [p.detach().requires_grad_(True) for p in leaves(tparams)]
    params = unflatten(tparams, flat)
    toks = torch.from_numpy(_batch(tcfg, seed=3)["tokens"])
    logits, aux = model.forward(params, toks)
    assert not logits.requires_grad and not aux.requires_grad
    loss = model.loss(params, {"tokens": toks, "labels": toks})
    assert loss.requires_grad


@pytest.mark.parametrize("b,l,h,p,g,n,chunk", [(2, 128, 4, 16, 1, 8, 32),
                                               (1, 96, 4, 8, 2, 16, 32),
                                               (2, 64, 2, 8, 1, 8, 64)])
def test_ssd_chunked_value_and_gradient_match_jax(b, l, h, p, g, n, chunk):
    """The loss path's scan against the reference's ``ssd_chunked``: y and
    the final state at 2e-5 of their largest magnitude, and the gradient
    of a random projection of both with respect to x, dt, A, B and C at
    2e-4 of each input's largest |g| (float32 sums over a chunk, in
    another order: a loop where the reference runs an associative scan)."""
    rng = np.random.default_rng(b * 1000 + l + h + g)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, l, h)))) * 0.5) \
        .astype(np.float32)
    A = -np.linspace(0.5, 2.0, h).astype(np.float32)
    B = rng.standard_normal((b, l, g, n)).astype(np.float32)
    C = rng.standard_normal((b, l, g, n)).astype(np.float32)
    wy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    ws = rng.standard_normal((b, h, p, n)).astype(np.float32)

    def jax_obj(*args):
        y, st = jssm.ssd_chunked(*args, chunk)
        return jnp.sum(y * wy) + jnp.sum(st * ws), (y, st)

    (_, (jy, jst)), jg = jax.value_and_grad(jax_obj, argnums=range(5),
                                            has_aux=True)(x, dt, A, B, C)
    targs = [torch.from_numpy(a).requires_grad_(True)
             for a in (x, dt, A, B, C)]
    ty, tst = tssm.ssd_chunked(*targs, chunk=chunk)
    (torch.sum(ty * torch.from_numpy(wy))
     + torch.sum(tst * torch.from_numpy(ws))).backward()
    for got, want in ((ty, jy), (tst, jst)):
        want = np.asarray(want)
        err = np.abs(got.detach().numpy() - want).max()
        assert err <= 2e-5 * np.abs(want).max(), err
    for name, t, j in zip("x dt A B C".split(), targs, jg):
        j = np.asarray(j)
        err = np.abs(t.grad.numpy() - j).max()
        assert err <= 2e-4 * np.abs(j).max(), (name, err)


def test_ssm_loss_path_reaches_no_kernel_wrapper(monkeypatch):
    """``Model.loss`` takes ``ssd_chunked``; ``forward`` keeps the kernel's
    wrapper (its plain version on the CPU)."""
    from repro_torch.kernels import ssd_scan as kmod
    calls, plain = [], kmod.ref.ssd_scan

    def counting(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(kmod.ref, "ssd_scan", counting)
    _, _, tcfg, tparams = _setup("mamba2-1.3b")
    model = Model(tcfg)
    toks = torch.from_numpy(_batch(tcfg, seed=4)["tokens"])
    loss = model.loss(tparams, {"tokens": toks, "labels": toks})
    assert torch.isfinite(loss) and not calls
    model.forward(tparams, toks)
    assert len(calls) == tcfg.num_layers
