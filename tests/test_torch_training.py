"""The port's training substrate against the JAX package, on the CPU:
``cross_entropy``, the AdamW optimizer (schedule, clipping, decay by the
stored leaf's rank), three ``make_train_step`` steps of smoke danube, the
synthetic corpus, checkpoint bytes in both directions, learning on the
corpus, the train launcher, and the kernel wrappers' refusal under
autograd.

Inputs come from numpy with a seed; weights from a JAX ``Model.init`` tree
carried over by the bridge. Tolerances are stated where they are used.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import Model as JaxModel
from repro.models.layers import cross_entropy as jax_cross_entropy
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import SyntheticCorpus as JaxCorpus
from repro.training.train_loop import make_train_step as jax_train_step

from repro_torch.bridge import from_numpy_tree, to_numpy_tree
from repro_torch.configs import ArchConfig, smoke_config
from repro_torch.kernels import flash_prefill as tflash
from repro_torch.kernels import paged_attention as tpaged
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.launch import train as train_launcher
from repro_torch.models.layers import cross_entropy, pad_vocab
from repro_torch.models.transformer import Model
from repro_torch.training import checkpoint, optimizer
from repro_torch.training.data import DataConfig, SyntheticCorpus
from repro_torch.training.train_loop import (TrainConfig, batch_to,
                                             make_train_step, train)
from repro_torch.training.tree import leaves, unflatten


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one CPU thread: beside other test processes a threaded BLAS
    oversubscribes the cores (the learning test took 839 s instead of
    5)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ordered(bits, width):
    """Raw float bits (uint16 of bf16, uint32 of float32) as integers in
    the order of the values they encode: two values n ulps apart are n
    apart here, across zero too."""
    b = bits.astype(np.int64)
    mag = b & ((1 << (width - 1)) - 1)
    return np.where(b >> (width - 1), -mag, mag)


def _ulps(got, want):
    """|ulp distance| of a port leaf (numpy from ``to_numpy_tree``) from a
    JAX leaf of the same dtype, elementwise."""
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        return np.abs(_ordered(got, 16) - _ordered(want.view(np.uint16), 16))
    assert want.dtype == np.float32
    return np.abs(_ordered(got.view(np.uint32), 32)
                  - _ordered(want.view(np.uint32), 32))


# -- cross_entropy --------------------------------------------------------------

def test_cross_entropy_matches_jax_with_masked_labels_and_padded_vocab():
    """Value at 1e-6 relative, gradient with respect to the logits at 1e-6
    of its largest magnitude (float32 logsumexp in both)."""
    rng = np.random.default_rng(0)
    vocab, b, s = 500, 3, 17
    vpad = pad_vocab(vocab)
    logits = (rng.standard_normal((b, s, vpad)) * 3).astype(np.float32)
    logits[..., vocab:] = np.finfo(np.float32).min  # as unembed masks them
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[0, :4] = -1
    labels[2, 9] = -1
    jval, jgrad = jax.value_and_grad(jax_cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels), vocab)
    t = torch.from_numpy(logits).requires_grad_(True)
    val = cross_entropy(t, torch.from_numpy(labels), vocab)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-6)
    jgrad = np.asarray(jgrad)
    assert np.abs(t.grad.numpy() - jgrad).max() <= \
        1e-6 * np.abs(jgrad).max()
    # every label masked: the mean is over max(valid, 1), so zero
    none = torch.full((b, s), -1, dtype=torch.int32)
    assert float(cross_entropy(t.detach(), none, vocab)) == 0.0


# -- optimizer --------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 60, 110, 200])
def test_schedule_matches_jax(step):
    """Float32 arithmetic in both: equal to 1 ulp."""
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=110, min_lr_frac=0.1)
    got = optimizer.schedule(optimizer.OptConfig(**cfg), step)
    want = jopt.schedule(jopt.OptConfig(**cfg), jnp.int32(step))
    assert got.dtype == torch.float32
    assert _ulps(got.numpy().view(np.uint32), np.asarray(want)).max() <= 1


def _opt_tree(rng, dtype):
    """A tree shaped like a model's: a stacked 2-layer segment whose norm
    scale is 2-D, a one-layer segment whose norm scale is 1-D, a float32
    router, a stacked 3-D matrix."""
    def arr(*shape, scale=1.0, dt=dtype):
        return (rng.standard_normal(shape) * scale).astype(dt)
    return {"embed": {"table": arr(64, 16, scale=0.02)},
            "final_norm": {"scale": arr(16)},
            "segments": [
                {"ln1": {"scale": arr(2, 16)},
                 "mlp": {"up": {"w": arr(2, 16, 32, scale=0.25)}}},
                {"ln1": {"scale": arr(16)},
                 "router": {"w": arr(16, 4, dt=np.float32)}}]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.05])
def test_adamw_apply_matches_jax(dtype, clip):
    """Five steps of ``apply`` on the same parameters and gradients as the
    reference's: grad_norm and lr at 1e-6 relative; float32 leaves and
    moments at 1e-5 of their largest magnitude (the clip scale divides by
    the global norm, a float32 sum in another order: an ulp there scales
    every gradient); bf16 parameters at most
    one ulp apart, on at most 0.5% of the elements (one float32 rounding
    of p - lr * delta may fall on the other side of a bf16 midpoint). The
    stacked 2-D norm scale is decayed and the one-layer 1-D one is not, in
    both (the reference's rule reads the stored rank)."""
    rng = np.random.default_rng(7)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    base = _opt_tree(rng, np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(
        jdt if a.dtype == np.float32 and a.shape != (16, 4) else a.dtype),
        base)
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp))
    cfg = dict(lr=3e-2, warmup_steps=2, total_steps=8, grad_clip=clip)
    jcfg, tcfg = jopt.OptConfig(**cfg), optimizer.OptConfig(**cfg)
    js, ts = jopt.init(jp), optimizer.init(tp)
    for i in range(5):
        g = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * 0.3).astype(a.dtype),
            jax.tree.map(np.asarray, jp))
        jp, js, jm = jopt.apply(jcfg, jp, g, js)
        tp, ts, tm = optimizer.apply(tcfg, tp, from_numpy_tree(g), ts)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)
    assert int(ts.step) == int(js.step) == 5
    off = total = 0
    for got, want in zip(to_numpy_tree(leaves(tp)), jax.tree.leaves(jp)):
        u = _ulps(got, want)
        if np.asarray(want).dtype.name == "bfloat16":
            assert u.max() <= 1
            off, total = off + int((u > 0).sum()), total + u.size
        else:
            want = np.asarray(want)
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert off <= 0.005 * max(total, 1), (off, total)
    for got, want in zip(leaves(ts.mu) + leaves(ts.nu),
                         jax.tree.leaves(js.mu) + jax.tree.leaves(js.nu)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= \
            1e-5 * np.abs(want).max()


def test_decay_reads_the_stored_rank():
    """With zero gradients only weight decay moves a leaf: the stacked
    2-D norm scale shrinks, the 1-D one stays (as in the reference)."""
    tp = {"a": torch.ones(2, 4), "b": torch.ones(4)}
    cfg = optimizer.OptConfig(lr=0.1, warmup_steps=0, weight_decay=0.5)
    tp, _, _ = optimizer.apply(cfg, tp, {k: torch.zeros_like(v) for k, v in
                                         tp.items()}, optimizer.init(tp))
    assert (tp["a"] < 1).all() and (tp["b"] == 1).all()


def test_adamw_moves_toward_minimum_and_clips():
    """The reference's own optimizer tests, on the port."""
    cfg = optimizer.OptConfig(lr=0.1, warmup_steps=0, total_steps=400,
                              min_lr_frac=1.0, weight_decay=0.0,
                              grad_clip=100.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = optimizer.init(params)
    for _ in range(400):
        params, state, _ = optimizer.apply(cfg, params,
                                           {"w": 2 * params["w"]}, state)
    assert float(params["w"].abs().max()) < 0.2
    cfg = optimizer.OptConfig(lr=1.0, warmup_steps=0, grad_clip=1.0,
                              weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    _, _, m = optimizer.apply(cfg, params, {"w": torch.full((4,), 100.0)},
                              optimizer.init(params))
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_global_norm_sums_leaves_in_the_reference_order():
    rng = np.random.default_rng(3)
    tree = {"z": rng.standard_normal(5).astype(np.float32),
            "a": [rng.standard_normal((3, 2)).astype(np.float32),
                  {"y": rng.standard_normal(4).astype(np.float32),
                   "b": rng.standard_normal(2).astype(np.float32)}]}
    got = optimizer.global_norm(from_numpy_tree(tree))
    want = jopt.global_norm(jax.tree.map(jnp.asarray, tree))
    assert float(got) == float(want)
    assert [x.shape for x in leaves(from_numpy_tree(tree))] == \
        [x.shape for x in jax.tree.leaves(tree)]


# -- train steps ------------------------------------------------------------

# (dtype, loss rtol, grad_norm rtol, the fraction of parameters allowed
# more than 0.1 x lr apart, and for bf16 the fraction allowed more than one
# ulp apart). Adam's first steps move each element by about lr whatever
# its gradient's size, so an element whose gradient lies within the
# packages' rounding difference of zero steps the other way: such elements
# differ by up to 2 x lr (seen: float32 0.12% beyond 0.1 x lr after three
# steps; bf16, whose gradients are computed in bf16, 4.4% beyond one ulp).
STEP_TOL = {"float32": (1e-4, 1e-3, 0.01, None),
            "bfloat16": (2e-4, 5e-3, 0.2, 0.1)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_train_steps_match_jax(dtype):
    """Smoke danube (two stacked layers), 4 x 64 tokens a step from the
    corpus, three steps of the port's ``make_train_step`` against the
    reference's jitted one from the same weights: lr equal to 1 ulp, loss
    and grad_norm at the stated rtol every step; parameters, in every
    element, within 2 x (the sum of the lrs) x (1 + wd |p|) of the
    reference's (in the first three steps of b1 0.9, b2 0.95 an Adam step
    moves an element by at most lr (1 + wd |p|), up to 2e-4 of lr), plus in
    bf16 the roundings of six updates (half an ulp, 2**-8 |p|, each); and
    beyond 0.1 x lr (or one bf16 ulp) only on the stated fraction."""
    loss_rtol, gn_rtol, frac_far, frac_ulp = STEP_TOL[dtype]
    jcfg = dataclasses.replace(jax_smoke_config("h2o-danube-1.8b"),
                               dtype=dtype)
    jm = JaxModel(jcfg, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp))
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jax_train_step(jm, jopt.OptConfig(**ocfg)))
    tstep = make_train_step(Model(ArchConfig(**dataclasses.asdict(jcfg))),
                            optimizer.OptConfig(**ocfg))
    js, ts = jopt.init(jp), optimizer.init(tp)
    corpus = SyntheticCorpus(DataConfig(vocab_size=jcfg.vocab_size,
                                        seq_len=64, global_batch=4))
    lr_sum = 0.0
    for _, batch in zip(range(3), corpus.batches()):
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        tp, ts, tmet = tstep(tp, ts, batch_to(batch, "cpu"))
        assert _ulps(tmet["lr"].numpy().view(np.uint32),
                     np.asarray(jmet["lr"])).max() <= 1
        np.testing.assert_allclose(float(tmet["loss"]),
                                   float(jmet["loss"]), rtol=loss_rtol)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=gn_rtol)
        lr_sum += float(jmet["lr"])
    far = ulp = total = 0
    for got, want in zip(to_numpy_tree(leaves(tp)), jax.tree.leaves(jp)):
        want = np.asarray(want)
        w32 = np.abs(want.astype(np.float32))
        bound = 2 * lr_sum * (1 + 0.1 * w32) * (1 + 2e-4) + 1e-7
        if want.dtype.name == "bfloat16":
            g32 = (got.astype(np.uint32) << 16).view(np.float32)
            ulp += int((_ulps(got, want) > 1).sum())
            bound = bound + 6 * 2.0 ** -8 * w32
        else:
            g32 = got
        d = np.abs(g32 - want.astype(np.float32))
        assert (d <= bound).all(), float((d - bound).max())
        far += int((d > 0.1 * ocfg["lr"]).sum())
        total += d.size
    assert far <= frac_far * total, (far, total)
    if frac_ulp is not None:
        assert ulp <= frac_ulp * total, (ulp, total)


# -- data -------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed,start",
                         [(512, 64, 4, 3, 0), (32000, 256, 2, 0, 0),
                          (1000, 128, 3, 5, 7)])
def test_corpus_batches_equal_the_reference(vocab, seq, batch, seed, start):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    mine = SyntheticCorpus(DataConfig(**kw)).batches(start_step=start)
    ref = JaxCorpus(JaxDataConfig(**kw)).batches(start_step=start)
    for _ in range(4):
        a, b = next(mine), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()


# -- checkpoints ------------------------------------------------------------

MSGPACK_CASES = [
    {}, [], 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
    "", "x" * 31, "y" * 32, "z" * 255, "w" * 256, "v" * 70000, "äö",
    b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 70000,
    list(range(15)), list(range(16)), list(range(70000)),
    {f"k{i}": i for i in range(15)}, {f"k{i}": i for i in range(16)},
    {"leaves": [{"dt": "<f4", "shape": [2, 3], "data": b"\x00" * 24}]},
]


@pytest.mark.parametrize("obj", MSGPACK_CASES,
                         ids=[str(i) for i in range(len(MSGPACK_CASES))])
def test_msgpack_subset_equals_msgpack(obj):
    assert checkpoint.packb(obj) == msgpack.packb(obj, use_bin_type=True)
    assert checkpoint.unpackb(msgpack.packb(obj, use_bin_type=True)) == \
        msgpack.unpackb(msgpack.packb(obj, use_bin_type=True), raw=False)


def _ckpt_trees():
    """{"params", "opt"} of smoke danube (bf16 weights, float32 moments,
    an int32 step) and a leaf of each other dtype, in both packages."""
    jcfg = jax_smoke_config("h2o-danube-1.8b")
    jp = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(1))
    js = jopt.init(jp)
    js = js._replace(step=jnp.int32(3), mu=jax.tree.map(
        lambda m: m + 0.25, js.mu))
    extra = {"i16": np.arange(5, dtype=np.int16),
             "scalar": np.float32(2.5), "u8": np.arange(300) % 256}
    extra["u8"] = extra["u8"].astype(np.uint8)
    jtree = {"params": jp, "opt": js,
             "extra": jax.tree.map(jnp.asarray, extra)}
    ttree = {"params": from_numpy_tree(jax.tree.map(np.asarray, jp)),
             "opt": optimizer.OptState(
                 step=torch.tensor(3, dtype=torch.int32),
                 mu=from_numpy_tree(jax.tree.map(np.asarray, js.mu)),
                 nu=from_numpy_tree(jax.tree.map(np.asarray, js.nu))),
             "extra": {k: torch.from_numpy(np.asarray(v))
                       for k, v in extra.items()}}
    return jtree, ttree


def test_checkpoint_bytes_equal_and_restore_both_ways(tmp_path):
    jtree, ttree = _ckpt_trees()
    jdir = jckpt.save(str(tmp_path / "jax"), 12, jtree)
    tdir = checkpoint.save(str(tmp_path / "port"), 12, ttree)
    for name in ("ckpt.msgpack", "manifest.json"):
        assert (tmp_path / "jax" / "step_00000012" / name).read_bytes() == \
            (tmp_path / "port" / "step_00000012" / name).read_bytes()
    assert jdir.endswith("step_00000012") and tdir.endswith("step_00000012")
    assert checkpoint.latest_step(str(tmp_path / "port")) == 12
    assert checkpoint.latest_step(str(tmp_path / "none")) is None

    # the port restores the reference's checkpoint, bit for bit
    back = checkpoint.restore(str(tmp_path / "jax"), 12, ttree)
    assert isinstance(back["opt"], optimizer.OptState)
    for got, want in zip(leaves(back), leaves(ttree)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.int16) if got.dtype ==
                           torch.bfloat16 else got,
                           want.view(torch.int16) if want.dtype ==
                           torch.bfloat16 else want)
    # and the reference restores the port's
    jback = jckpt.restore(str(tmp_path / "port"), 12, jtree)
    for got, want in zip(jax.tree.leaves(jback), jax.tree.leaves(jtree)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_checkpoint_round_trip_keeps_devices_and_order(tmp_path):
    tree = {"b": [torch.arange(3, dtype=torch.int32),
                  torch.ones(2, 2, dtype=torch.bfloat16) * 1.5],
            "a": {"y": torch.tensor(2.5), "x": torch.zeros(0)}}
    checkpoint.save(str(tmp_path), 7, tree)
    back = checkpoint.restore(str(tmp_path), 7, tree)
    assert list(back) == ["b", "a"] and list(back["a"]) == ["y", "x"]
    for got, want in zip(leaves(back), leaves(tree)):
        assert got.dtype == want.dtype and got.device == want.device
        assert torch.equal(got.float(), want.float())
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(str(tmp_path), 7, {"a": tree["a"]})


def test_tree_order_is_jax_order():
    from repro_torch.training.tree import tree_map
    tree = {"b": [1, (2, 3)], "a": {"d": 4, "c": None},
            "o": optimizer.OptState(5, [6], {"z": 7, "y": 8})}
    assert leaves(tree) == jax.tree.leaves(tree)
    assert unflatten(tree, [10 * x for x in leaves(tree)]) == \
        tree_map(lambda x: 10 * x, tree)
    with pytest.raises(ValueError):
        unflatten(tree, list(range(20)))


# -- learning, the loop and the launcher ------------------------------------

def test_model_learns_on_synthetic_corpus():
    """The port's counterpart of ``tests/test_training.py::
    test_model_learns_on_synthetic_corpus``: the same schedule and bound."""
    cfg = smoke_config("h2o-danube-1.8b")
    res = train(cfg, TrainConfig(
        steps=80, log_every=79,
        opt=optimizer.OptConfig(lr=1.5e-3, warmup_steps=10,
                                total_steps=80)),
        verbose=False, device="cpu")
    first, last = res["losses"][0][1], res["losses"][-1][1]
    assert last < first - 0.25, f"no learning: {first:.3f} -> {last:.3f}"


def test_train_launcher_reduced_on_cpu(tmp_path, capsys):
    out = train_launcher.main(["--reduced", "--device", "cpu", "--steps",
                               "3", "--ckpt-dir", str(tmp_path)])
    assert out["steps"] == 3 and len(out["losses"]) == 3
    assert all(math.isfinite(x) for x in out["losses"] + out["grad_norms"])
    assert out["tokens_per_step"] == 8 * 256 and out["peak_gib"] is None
    printed = capsys.readouterr().out
    assert "step     0 loss" in printed and "step     2 loss" in printed
    assert "tokens/s" in printed
    # its checkpoint restores in the reference
    jp = JaxModel(jax_smoke_config("h2o-danube-1.8b")).init(
        jax.random.PRNGKey(0))
    assert jckpt.latest_step(str(tmp_path)) == 3
    back = jckpt.restore(str(tmp_path), 3, {"params": jp})
    assert jax.tree.map(lambda a: (a.shape, a.dtype), back) == \
        jax.tree.map(lambda a: (a.shape, a.dtype), {"params": jp})


@pytest.mark.parametrize("flags", [["--production-mesh",
                                    "--model-parallel", "2"],
                                   ["--production-mesh"]])
def test_train_launcher_refuses_sharding(flags):
    """The production mesh needs 256 ranks; one rank is refused with the
    world size it needs (``--model-parallel`` alone runs: it falls back
    to 1 where it does not divide, ``tests/test_torch_sharding.py``)."""
    import torch.distributed as dist
    with pytest.raises(ValueError, match="world size of 256"):
        train_launcher.main(["--reduced", "--device", "cpu", *flags])
    assert not dist.is_initialized()


# -- the kernel wrappers refuse autograd --------------------------------------

def _kernel_calls():
    rng = np.random.default_rng(11)

    def t(*shape, dt=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(dt)

    q4, k4, v4 = t(1, 8, 4, 16), t(1, 8, 2, 16), t(1, 8, 2, 16)
    pool_k, pool_v = t(3, 4, 2, 16), t(3, 4, 2, 16)
    pages = torch.tensor([0, 2], dtype=torch.int32)
    tables = torch.tensor([[1, 2]], dtype=torch.int32)
    lens = torch.tensor([6], dtype=torch.int32)
    x, bm, cm = t(1, 32, 2, 8), t(1, 32, 1, 4), t(1, 32, 1, 4)
    dt = torch.rand(1, 32, 2) * 0.1
    a = -torch.ones(2)
    return {
        "flash_prefill": (lambda q: tflash.flash_prefill(q, k4, v4), q4),
        "prefill_attention": (
            lambda q: tflash.prefill_attention(q, k4, v4), q4),
        "prefill_attention_paged": (
            lambda q: tflash.prefill_attention_paged(
                q, pool_k, pool_v, pages, q_offset=0), q4),
        "paged_attention": (
            lambda q: tpaged.paged_attention(q[0, :1], pool_k, pool_v,
                                             tables, lens, page_size=4),
            q4),
        "ssd_scan": (lambda xx: tssd.ssd_scan(xx, dt, a, bm, cm, chunk=16),
                     x),
    }


@pytest.mark.parametrize("name", ["flash_prefill", "prefill_attention",
                                  "prefill_attention_paged",
                                  "paged_attention", "ssd_scan"])
def test_kernel_wrappers_refuse_autograd(name):
    """A kernel has no backward: each wrapper raises where autograd would
    record it, on the CPU as on the card, and runs under no_grad or on
    inputs that need no gradient."""
    fn, arg = _kernel_calls()[name]
    with pytest.raises(RuntimeError, match="no backward"):
        fn(arg.clone().requires_grad_(True))
    with torch.no_grad():
        fn(arg.clone().requires_grad_(True))
    fn(arg)


# -- examples/torch_train_small.py ---------------------------------------------

def test_train_small_example_at_smoke_size(tmp_path):
    """The port's training example, shrunk (``--smoke``: 2 layers, d_model
    128) on the CPU for 6 steps: finite losses, a checkpoint at step 4
    (every steps // 3) and one resumed step from it; its full-size model
    is the reference example's ~100M parameters."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "torch_train_small.py")
    spec = importlib.util.spec_from_file_location("torch_train_small", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    out = ex.main(["--smoke", "--device", "cpu", "--steps", "6",
                   "--ckpt-dir", str(tmp_path)])
    assert out["latest"] == 4
    assert all(math.isfinite(x) for _, x in out["losses"])
    assert math.isfinite(out["resumed_loss"])
    from repro.configs import get_config as jget
    full = ex.config(smoke=False)
    ref = dataclasses.replace(
        jget("h2o-danube-1.8b"), num_layers=8, d_model=768, num_heads=12,
        num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000,
        sliding_window=512)
    assert full.n_params() == ref.n_params()
    assert 90e6 < full.n_params() < 130e6
