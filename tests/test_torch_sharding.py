"""The port's sharding (``repro_torch.launch.{mesh,sharding}``,
``core/distkv/dist_attention``'s mesh half, the policy hooks of the
models) against the JAX package, on the CPU.

* **The reference's decisions, without devices.** The JAX package's
  ``param_spec`` / ``batch_shardings`` / ``cache_shardings`` and
  ``MeshPolicy.act`` / ``param`` run on an ``AbstractMesh``; the
  reference's policy is read through a subclass whose ``_c`` returns the
  spec. The port's must give the same ``PartitionSpec``s at 16 x 16,
  2 x 16 x 16 and 2 x 4 for every arch at full width (shapes only: fake
  and meta tensors).
* **Sharded equals one device.** One group of 8 gloo ranks on a 2 x 4
  ``("data", "model")`` mesh (``tests/torch_mesh_worker.py``), spawned once
  for the module, runs a sharded train step of smoke danube, the sharded
  forward of smoke deepseek-v2 (MLA + MoE through ``moe_apply``) and
  ``dist_attention``; a one-rank group holds ``Model.loss`` and its
  gradients under a one-rank ``MeshPolicy`` against no policy for six plan
  families; 4 ranks and 1 rank run the train launcher. The JAX package's
  mesh code cannot run on this JAX (``jax.make_mesh`` makes Explicit axes;
  ROADMAP §3), so the sharded results are held to its single-device ones.

Weights come from JAX ``Model.init`` trees, carried as float32 numpy.
Tolerances are stated where they are used.
"""

import dataclasses
import functools
import os
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import DTensor

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.configs import smoke_config as jax_smoke_config
from repro.core.distkv.dist_attention import \
    dist_attention_ref as jax_dist_attention_ref
from repro.launch import sharding as jshd
from repro.models import Model as JaxModel
from repro.training import optimizer as jopt
from repro.training.train_loop import make_train_step as jax_train_step

from repro_torch.bridge import from_numpy_tree, init_params
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, ArchConfig, \
    get_config, smoke_config
from repro_torch.core.distkv.dist_attention import dist_attention_ref
from repro_torch.launch import sharding as shd
from repro_torch.models.transformer import Model
from repro_torch.training import optimizer
from repro_torch.training.train_loop import make_train_step
from repro_torch.training.tree import leaves, unflatten

WORKER = os.path.join(os.path.dirname(__file__), "torch_mesh_worker.py")
SPAWN_TIMEOUT = 300  # seconds a rank group may take
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
FAMILIES = ["h2o-danube-1.8b", "deepseek-v2-236b", "mamba2-1.3b",
            "hymba-1.5b", "seamless-m4t-medium", "internvl2-26b"]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}


# -- spec helpers -------------------------------------------------------------

def _norm(spec):
    """A PartitionSpec's entries with 1-tuples as their name (JAX folds
    ``("data",)`` to ``"data"``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _spec_leaves(tree):
    """The specs of a port spec tree in ``jax.tree.flatten``'s order."""
    if isinstance(tree, shd.P):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    return [x for t in tree for x in _spec_leaves(t)]


def _meshes(name):
    shape, names = MESHES[name]
    ref = AbstractMesh(shape, names)
    port = types.SimpleNamespace(mesh_dim_names=names, shape=shape)
    return ref, port


class _RefSpecs(jshd.MeshPolicy):
    """The reference's MeshPolicy with ``_c`` returning the spec."""

    def _c(self, x, spec):
        return spec


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jax.eval_shape(JaxModel(jax_get_config(arch)).init,
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return init_params(get_config(arch), seed=0, device="cpu")


# -- the reference's decisions --------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh_name):
    """Every leaf of every arch at full width: the port's layout equals
    ``repro.launch.sharding.param_spec``."""
    ref_mesh, mesh = _meshes(mesh_name)
    cfg = get_config(arch)
    want = jax.tree_util.tree_map_with_path(
        lambda path, leaf: _norm(jshd.param_spec(path, leaf, ref_mesh,
                                                 jax_get_config(arch))),
        _ref_params(arch))
    got = shd.param_specs(_port_params(arch), mesh, cfg)
    want_l = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, tuple))
    got_l = [_norm(s) for s in _spec_leaves(got)]
    assert len(got_l) == len(want_l)
    assert got_l == want_l


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_match_reference(arch, mesh_name):
    ref_mesh, mesh = _meshes(mesh_name)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    from repro_torch.configs import input_specs
    for name, shape in INPUT_SHAPES.items():
        want = jshd.batch_shardings(jax_input_specs(jcfg, JAX_SHAPES[name]),
                                    ref_mesh, jcfg)
        got = shd.batch_specs(input_specs(cfg, shape), mesh, cfg)
        assert sorted(got) == sorted(want), name
        for k in want:
            assert _norm(got[k]) == _norm(want[k].spec), (name, k)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch, mesh_name):
    """Every decode shape's caches (meta tensors on the port's side)."""
    ref_mesh, mesh = _meshes(mesh_name)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in ("decode_32k", "long_500k"):
        shape = INPUT_SHAPES[name]
        enc = shape.seq_len // 4 if cfg.is_encdec else 0
        want = jshd.cache_shardings(
            JaxModel(jcfg).init_cache(shape.global_batch, shape.seq_len,
                                      as_specs=True, enc_len=enc),
            ref_mesh, jcfg, shape.global_batch)
        caches = Model(cfg).init_cache(shape.global_batch, shape.seq_len,
                                       device="meta", enc_len=enc)
        got = shd.cache_specs(caches, mesh, cfg, shape.global_batch)
        want_l = [_norm(s.spec) for s in jax.tree.leaves(want)]
        got_l = [_norm(s) for s in _spec_leaves(got)]
        assert got_l == want_l, name


# a table of (kind, shape) that reaches each branch and fallback of
# MeshPolicy.act at 16-way and 4-way axes: batches that do and do not
# divide, hymba's 25 heads / 5 KV heads, mistral's 96 / 8, danube's 32 / 8
ACT_CASES = [
    ("act_bsd", (256, 4096, 2560)), ("act_bsd", (3, 7, 2560)),
    ("act_bsd", (256, 4096, 1600)), ("act_bsd", (2, 16, 6)),
    ("ffn_bsf", (256, 4096, 6912)), ("ffn_bsf", (256, 4096, 5504)),
    ("ffn_bsf", (1, 9, 6)),
    ("logits_bsv", (256, 4096, 32256)), ("logits_bsv", (1, 1, 32001)),
    ("heads_bshd", (256, 4096, 32, 80)), ("heads_bshd", (256, 4096, 25, 64)),
    ("heads_bshd", (1, 8, 96, 128)),
    ("kv_bshd", (256, 4096, 8, 80)), ("kv_bshd", (256, 4096, 16, 128)),
    ("kv_bshd", (256, 4095, 5, 64)), ("kv_bshd", (32, 32768, 5, 64)),
    ("kvcache_bskd", (128, 32768, 8, 128)),
    ("kvcache_bskd", (1, 524288, 8, 128)),
    ("kvcache_bskd", (1, 1000, 8, 128)), ("kvcache_bskd", (1, 4096, 5, 64)),
    ("kvcache_bskd", (3, 4000, 8, 128)),
    ("mlacache_bsr", (128, 32768, 512)), ("mlacache_bsr", (1, 524288, 512)),
    ("mlacache_bsr", (1, 100, 512)),
    ("expert_gecd", (16, 16, 1024, 5120)), ("expert_gecd", (16, 160, 64, 5120)),
    ("expert_gecf", (1, 6, 8, 1536)), ("expert_gecd", (3, 4, 8, 256)),
    ("kvrep_bshd", (256, 4096, 96, 128)), ("kvrep_bshd", (3, 4096, 96, 128)),
    ("scores_bchs", (256, 512, 96, 4096)),
    ("scores_bchgs", (256, 512, 16, 2, 4096)),
    ("scores_bchgs", (256, 512, 8, 4, 4096)),
    ("scores_bchgs", (256, 512, 5, 5, 4095)),
    ("ssm_bshp", (256, 4096, 64, 64)), ("ssm_bshp", (256, 4096, 50, 64)),
    ("ssm_bshp", (256, 4096, 3200)),
    ("tokens_bs", (256, 4096)), ("unknown", (4, 4)),
]


@pytest.mark.parametrize("megatron", [True, False])
@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_mesh_policy_decisions_match_reference(mesh_name, decode, megatron):
    """``act`` for every kind over ``ACT_CASES``, ``param`` over weights
    of every rank and width, ``prefers_flat_heads`` and ``moe_groups``."""
    ref_mesh, mesh = _meshes(mesh_name)
    jcfg = jax_get_config("mistral-large-123b")
    ref = _RefSpecs(ref_mesh, jcfg, decode=decode, megatron=megatron)
    pol = shd.MeshPolicy(mesh, get_config("mistral-large-123b"),
                         decode=decode, megatron=megatron)
    assert pol.moe_groups == ref.moe_groups
    assert (pol.dp, pol.dp_size, pol.mp, pol.mp_size) == \
        (tuple(ref.dp), ref.dp_size, ref.mp, ref.mp_size)
    for kind, shape in ACT_CASES:
        x = jax.ShapeDtypeStruct(shape, jnp.float32)
        want = ref.act(x, kind)
        got = pol.act_spec(shape, kind)
        if want is x:
            assert got is None, (kind, shape, got)
        else:
            assert got is not None and _norm(got) == _norm(want), \
                (kind, shape, got, want)
    for shape in [(2560, 6912), (12288, 1000), (88, 12288, 28672), (7,),
                  (160, 5120, 1536), (3, 5)]:
        for kind in ("matmul_weight", "other"):
            x = jax.ShapeDtypeStruct(shape, jnp.float32)
            want = ref.param(x, kind)
            got = pol.param_spec_for(shape, kind)
            if want is x:
                assert got is None, (shape, kind)
            else:
                assert _norm(got) == _norm(want), (shape, kind)
    for h, hkv in [(96, 8), (32, 8), (25, 5), (40, 8), (128, 128), (4, 4)]:
        assert pol.prefers_flat_heads(h, hkv) == \
            ref.prefers_flat_heads(h, hkv), (h, hkv)


def test_placements_follow_specs():
    """A spec entry naming several mesh dimensions shards its tensor
    dimension over each, major first; DTensor's order."""
    from torch.distributed.tensor import Replicate, Shard
    _, mesh = _meshes("2x16x16")
    assert shd.placements_of(shd.P(("pod", "data"), None, "model"), mesh) \
        == [Shard(0), Shard(0), Shard(2)]
    assert shd.placements_of(shd.P(), mesh) == [Replicate()] * 3
    assert shd.placements_of(shd.P(None, ("data", "model")), mesh) == \
        [Replicate(), Shard(1), Shard(1)]
    # the *_shardings are the specs' placements, leaf for leaf
    cfg = get_config("h2o-danube-1.8b")
    params = _port_params("h2o-danube-1.8b")
    assert leaves(shd.param_shardings(params, mesh, cfg)) == [
        p for s in _spec_leaves(shd.param_specs(params, mesh, cfg))
        for p in shd.placements_of(s, mesh)]
    assert shd.replicated({"a": params["embed"]["table"]}, mesh) == \
        {"a": [Replicate()] * 3}


# -- sharded runs: the rank groups ------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(job, world, d):
    """``world`` ranks of ``torch_mesh_worker.py <job>``, one thread
    each."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.join(os.path.dirname(__file__), "..",
                                     "src"),
                        os.environ.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, job, d], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _wait(procs, job):
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), \
        f"{job}: ranks exited {[p.returncode for p in procs]}\n{outs[0]}"


def _inputs():
    out = {}
    for name, arch in (("danube", "h2o-danube-1.8b"),
                       ("deepseek", "deepseek-v2-236b")):
        jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
        tree = from_numpy_tree(jax.tree.map(
            np.asarray, JaxModel(jcfg).init(jax.random.PRNGKey(0))))
        for i, t in enumerate(leaves(tree)):
            out[f"{name}{i}"] = t.numpy()
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (4, 64)).astype(np.int32)
    labels = toks.copy()
    labels[0, :5] = -1
    out["batch_tokens"], out["batch_labels"] = toks, labels
    out["moe_tokens"] = rng.integers(0, 512, (4, 32)).astype(np.int32)
    out["decode_prompt"] = rng.integers(0, 512, (4, 40)).astype(np.int32)
    out["decode_token"] = rng.integers(0, 512, (4, 1)).astype(np.int32)
    # the reference test's DistAttention inputs (B 4, H 8, S 256, Hkv 2)
    out["da_q"] = rng.standard_normal((4, 8, 64)).astype(np.float32)
    out["da_k"] = rng.standard_normal((4, 256, 2, 64)).astype(np.float32)
    out["da_v"] = rng.standard_normal((4, 256, 2, 64)).astype(np.float32)
    out["da_lens"] = np.array([3, 100, 256, 177], np.int32)
    out["families"] = np.array(FAMILIES)
    for arch in FAMILIES:
        cfg = smoke_config(arch)
        t = rng.integers(0, 512, (2, 64)).astype(np.int32)
        lab = t.copy()
        lab[1, :3] = -1
        out[f"{arch}/tokens"], out[f"{arch}/labels"] = t, lab
        if cfg.is_encdec:
            out[f"{arch}/encoder_tokens"] = rng.integers(
                0, 512, (2, 32)).astype(np.int32)
        if cfg.num_media_tokens:
            out[f"{arch}/media"] = (rng.standard_normal(
                (2, cfg.num_media_tokens, cfg.d_model)) * 0.02) \
                .astype(np.float32)
    return out


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Spawn the rank groups once: 8 ranks (2 x 4) alone, then the
    one-rank families, the 4-rank and the 1-rank launcher together."""
    d = str(tmp_path_factory.mktemp("mesh"))
    inputs = _inputs()
    np.savez(os.path.join(d, "inputs.npz"), **inputs)
    _wait(_spawn("mesh", 8, d), "mesh")
    later = {"one": _spawn("one", 1, d)}
    d1 = os.path.join(d, "one_rank")
    os.makedirs(d1)
    os.link(os.path.join(d, "inputs.npz"), os.path.join(d1, "inputs.npz"))
    later["launch"] = _spawn("launch", 4, d)
    later["launch1"] = _spawn("launch", 1, d1)
    for job, procs in later.items():
        _wait(procs, job)
    res = {k: dict(np.load(os.path.join(d, f"{k}.npz")))
           for k in ("mesh", "one", "launch")}
    res["launch1"] = dict(np.load(os.path.join(d1, "launch.npz")))
    res["inputs"], res["dir"] = inputs, d
    return res


def _tree(inputs, prefix, cfg):
    like = init_params(cfg, seed=0, device="cpu")
    # copies: a train step updates its parameters in place
    return unflatten(like, [torch.tensor(inputs[f"{prefix}{i}"],
                                         dtype=t.dtype)
                            for i, t in enumerate(leaves(like))])


@pytest.fixture(scope="module")
def one_device_step(groups):
    """The port's and the reference's single-device step on the same
    weights and batch."""
    inputs = groups["inputs"]
    cfg = dataclasses.replace(smoke_config("h2o-danube-1.8b"),
                              dtype="float32")
    batch = {"tokens": torch.from_numpy(inputs["batch_tokens"]),
             "labels": torch.from_numpy(inputs["batch_labels"])}
    tp = _tree(inputs, "danube", cfg)
    step = make_train_step(Model(cfg), optimizer.OptConfig(**OPT))
    tp, _, tm = step(tp, optimizer.init(tp), batch)
    jcfg = dataclasses.replace(jax_smoke_config("h2o-danube-1.8b"),
                               dtype="float32")
    jm = JaxModel(jcfg, remat=False)
    jp = jax.tree.map(jnp.asarray, unflatten(
        jm.init(jax.random.PRNGKey(0)),
        [inputs[f"danube{i}"] for i in range(len(leaves(tp)))]))
    jstep = jax.jit(jax_train_step(jm, jopt.OptConfig(**OPT)))
    jp, _, jmet = jstep(jp, jopt.init(jp), {k: jnp.asarray(v.numpy())
                                            for k, v in batch.items()})
    return tp, tm, jp, jmet


def _adam_bound(got, want, lr):
    """Per element: within 2 lr (1 + wd |p|) of each other (an Adam first
    step moves an element by about lr whatever its gradient), plus float32
    rounding; beyond 0.1 lr on at most 1% of the elements (a gradient
    within rounding of zero)."""
    far = total = 0
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        bound = 2 * lr * (1 + 0.1 * np.abs(w)) * (1 + 2e-4) + 1e-7
        d = np.abs(np.asarray(g, np.float32) - w)
        assert (d <= bound).all(), float((d - bound).max())
        far += int((d > 0.1 * lr).sum())
        total += d.size
    assert far <= 0.01 * total, (far, total)


def test_sharded_train_step_matches_one_device(groups, one_device_step):
    """Smoke danube, float32, 4 x 64 tokens (five labels masked): the loss
    of the 2 x 4 step within 1e-5 relative of the port's one-device step,
    grad_norm within 1e-4, the updated parameters by the Adam bound. The
    gradient norm is not held to 1e-5: the attention rounds q, k, v and
    its probabilities to bf16 in float32 too (the reference's numerics),
    and a sharded product that sums in another order flips some of those
    roundings (single gradient elements 1e-3 apart, measured 3.1e-5 on the
    norm)."""
    tp, tm, _, _ = one_device_step
    m = groups["mesh"]
    np.testing.assert_allclose(m["step_loss"], float(tm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["step_grad_norm"], float(tm["grad_norm"]),
                               rtol=1e-4)
    got = [m[f"step_param{i}"] for i in range(len(leaves(tp)))]
    _adam_bound(got, [t.numpy() for t in leaves(tp)], float(tm["lr"]))


def test_sharded_checkpoint_is_the_whole_tree(groups):
    """The 2 x 4 step's DTensor parameters saved by the port's
    ``checkpoint.save`` (gathered, written by rank 0) hold the gathered
    tree's bytes, restore in the reference's ``checkpoint.restore``, and
    restore sharded in the port bit for bit."""
    from repro.training import checkpoint as jckpt
    m = groups["mesh"]
    assert bool(m["ckpt_same"])
    jcfg = dataclasses.replace(jax_smoke_config("h2o-danube-1.8b"),
                               dtype="float32")
    like = {"params": JaxModel(jcfg).init(jax.random.PRNGKey(0))}
    back = jax.tree.leaves(jckpt.restore(
        os.path.join(groups["dir"], "ckpt"), 1, like))
    for i, leaf in enumerate(back):
        np.testing.assert_array_equal(np.asarray(leaf), m[f"step_param{i}"])


def test_sharded_train_step_matches_jax(groups, one_device_step):
    """The same step against the reference's jitted single-device step:
    loss 1e-4 and grad_norm 1e-3 relative, parameters by the Adam bound
    (``test_torch_training.py``'s float32 tolerances)."""
    _, _, jp, jmet = one_device_step
    m = groups["mesh"]
    np.testing.assert_allclose(m["step_loss"], float(jmet["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(m["step_grad_norm"],
                               float(jmet["grad_norm"]), rtol=1e-3)
    want = jax.tree.leaves(jp)
    got = [m[f"step_param{i}"] for i in range(len(want))]
    _adam_bound(got, want, float(jmet["lr"]))


def _deepseek_logits(inputs, dtype):
    cfg = dataclasses.replace(smoke_config("deepseek-v2-236b"), dtype=dtype)
    params = _tree(inputs, "deepseek", cfg)
    logits, _ = Model(cfg).forward(params,
                                   torch.from_numpy(inputs["moe_tokens"]))
    return logits.float().numpy()


def _jax_deepseek_logits(inputs, dtype):
    jcfg = dataclasses.replace(jax_smoke_config("deepseek-v2-236b"),
                               dtype=dtype)
    jm = JaxModel(jcfg, remat=False)
    like = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    flat = jax.tree.leaves(like)
    jp = jax.tree.unflatten(jax.tree.structure(like), [
        jnp.asarray(inputs[f"deepseek{i}"]).astype(s.dtype)
        for i, s in enumerate(flat)])
    logits, _ = jm.forward(jp, jnp.asarray(inputs["moe_tokens"]))
    return np.asarray(logits.astype(jnp.float32))


def _moe_bounds(got, want, dtype):
    """The reference's own bounds (``tests/test_sharding.py:74-125``):
    float32 max error < 5e-3; bf16 mean error < 0.01 and argmax agreement
    >= 0.97 (a bf16 router near a tie may pick another expert for a
    token)."""
    d = np.abs(got - want)
    if dtype == "float32":
        assert d.max() < 5e-3, d.max()
    else:
        agree = (got.argmax(-1) == want.argmax(-1)).mean()
        assert d.mean() < 0.01 and agree >= 0.97, (d.mean(), agree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_moe_forward_matches_one_device(groups, dtype):
    """Smoke deepseek-v2 (MLA, MoE through the expert-parallel
    ``moe_apply``: 4 experts, one a model rank), 4 x 32 tokens."""
    _moe_bounds(groups["mesh"][f"moe_{dtype}"],
                _deepseek_logits(groups["inputs"], dtype), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_moe_forward_matches_jax(groups, dtype):
    """The same logits against the JAX package's single-device forward,
    by the same bounds."""
    _moe_bounds(groups["mesh"][f"moe_{dtype}"],
                _jax_deepseek_logits(groups["inputs"], dtype), dtype)


def test_decode_over_sequence_sharded_cache(groups):
    """Smoke danube, float32: a 40-token prefill on one device, its ring
    caches (64 slots, the window) laid out by ``cache_specs`` on 2 x 4
    (batch over data, slots over model), one ``decode_step`` under the
    decode policy (DistAttention: float32 partials per shard, merged)
    against the one-device decode step (bf16-rounded probabilities):
    logits within 2e-2 of each other, the argmax equal."""
    inputs = groups["inputs"]
    cfg = dataclasses.replace(smoke_config("h2o-danube-1.8b"),
                              dtype="float32")
    params = _tree(inputs, "danube", cfg)
    model = Model(cfg)
    prompt = torch.from_numpy(inputs["decode_prompt"])
    _, caches = model.prefill(params, prompt, seq_capacity=64)
    want, _ = model.decode_step(
        params, torch.from_numpy(inputs["decode_token"]),
        torch.full((4,), 40, dtype=torch.int32), caches)
    got = groups["mesh"]["decode_logits"]
    want = want.numpy()
    assert np.abs(got - want).max() < 2e-2, np.abs(got - want).max()
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_dist_attention_on_mesh(groups):
    """DistAttention over the 4-way ``model`` axis on the reference test's
    inputs (lengths 3 / 100 / 256 / 177): within 1e-5 of the port's
    ``dist_attention_ref`` and of the JAX package's."""
    inputs = groups["inputs"]
    args = [inputs[f"da_{n}"] for n in ("q", "k", "v", "lens")]
    got = groups["mesh"]["dist_attention"]
    port = dist_attention_ref(*map(torch.from_numpy, args)).numpy()
    ref = np.asarray(jax_dist_attention_ref(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, port, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_launcher_model_parallel_matches_one_rank(groups):
    """``repro_torch.launch.train --reduced --device cpu --model-parallel 2
    --steps 3`` on 4 ranks (2 x 2) against 1 rank: every loss and gradient
    norm finite and within 5e-5 relative. Not 1e-5: the reduced danube is
    bf16, and the row-parallel products (attention output, MLP down
    projection) sum bf16 partial products over ``model`` where one rank
    rounds once; measured 1.2e-5 to 2.2e-5 on steps 0-2 (the float32 step
    above holds 1e-5)."""
    got, want = groups["launch"], groups["launch1"]
    assert np.isfinite(got["losses"]).all()
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=5e-5)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               rtol=5e-4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_rank_mesh_policy_equals_no_policy(groups, arch):
    """Dense GQA, MLA + MoE, SSM, hybrid, encoder-decoder and media at
    smoke width, float32: on a one-rank mesh, ``Model.loss`` under
    ``MeshPolicy`` with DTensor parameters and batch equals the plain
    loss (1e-7 relative) and every gradient equals (1e-6 of the largest
    gradient element: seamless's cross-attention key bias, exactly zero in
    exact arithmetic, is rounding noise of 1e-7 in both, ROADMAP §3)."""
    o = groups["one"]
    np.testing.assert_allclose(o[f"{arch}/mesh/loss"],
                               o[f"{arch}/plain/loss"], rtol=1e-7)
    i = 0
    top = max(np.abs(v).max() for k, v in o.items()
              if k.startswith(f"{arch}/plain/grad"))
    while f"{arch}/plain/grad{i}" in o:
        g0, g1 = o[f"{arch}/plain/grad{i}"], o[f"{arch}/mesh/grad{i}"]
        assert g0.shape == g1.shape
        assert np.abs(g0 - g1).max() <= 1e-6 * top, (i, np.abs(g0).max())
        i += 1
    assert i > 10


# -- the train launcher on one rank ---------------------------------------------

def test_launcher_builds_the_host_mesh(capsys):
    """At world size 1 the launcher still builds ``make_host_mesh``; a
    ``--model-parallel`` that does not divide the world falls back to 1,
    as the reference's does, and the group it made is gone after."""
    import torch.distributed as dist
    from repro_torch.launch import train as train_launcher
    out = train_launcher.main(["--reduced", "--device", "cpu", "--steps",
                               "1", "--model-parallel", "2", "--seq-len",
                               "32", "--batch", "2"])
    assert out["mesh"] == {"data": 1, "model": 1}
    assert np.isfinite(out["losses"]).all()
    assert not dist.is_initialized()
    assert "mesh data 1 x model 1" in capsys.readouterr().out


def test_production_mesh_names_its_world_size():
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="world size of 256"):
            make_production_mesh()
        with pytest.raises(ValueError, match="world size of 512"):
            make_production_mesh(multi_pod=True)
    finally:
        dist.destroy_process_group()


def test_config_accounting_matches_reference():
    """``n_params``, ``n_active_params`` and ``supports_long_context`` of
    every arch equal the reference's with ``==``."""
    for arch in ARCH_IDS:
        c, r = get_config(arch), jax_get_config(arch)
        assert (c.n_params(), c.n_active_params(),
                c.supports_long_context) == \
            (r.n_params(), r.n_active_params(), r.supports_long_context)
        s, rs = smoke_config(arch), jax_smoke_config(arch)
        assert (s.n_params(), s.n_active_params()) == \
            (rs.n_params(), rs.n_active_params())
    assert ArchConfig(arch_id="x", family="dense", source="").n_params() \
        == 0


# -- the kernel wrappers refuse DTensors -------------------------------------

@pytest.mark.parametrize("name", ["flash_prefill", "prefill_attention",
                                  "prefill_attention_paged",
                                  "paged_attention", "ssd_scan"])
def test_kernel_wrappers_refuse_dtensors(name):
    """A kernel reads one device's memory: each wrapper raises for a
    DTensor argument on every device (here the CPU, where it would take
    its plain version), under no_grad too, and never falls back."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate
    from test_torch_training import _kernel_calls
    fn, arg = _kernel_calls()[name]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        darg = DTensor.from_local(arg, mesh, [Replicate()])
        with torch.no_grad(), pytest.raises(TypeError, match="DTensor"):
            fn(darg)
        fn(arg)  # the plain tensor still runs
    finally:
        dist.destroy_process_group()
