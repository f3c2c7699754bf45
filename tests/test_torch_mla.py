"""The port's MLA (DeepSeek-V2 multi-head latent attention) against the JAX
reference, on the CPU, on the smoke deepseek-v2-236b config (2 layers, d
256, 4 heads, latent r 64, q_lora 96, dn 32, dr 16, dv 32; 1 dense layer,
then MoE: 4 experts, top-2, 1 shared).

Inputs are made with numpy from a seed; weights go through
``repro_torch.bridge.from_numpy_tree``. Tolerances:

* functions that round nowhere but in their own type (``mla_absorb``, the
  effective K/V, ``attention_partial`` and its merge): float32 2e-5
  (``tests/test_kernels.py``'s);
* whole MLA blocks (``mla_forward``, ``mla_layer``): bfloat16 3e-2;
  float32 1e-2 in the worst element and 1e-4 in the median, as
  ``tests/test_torch_layers.py`` holds GQA's. Both packages round q, k, v
  (the absorbed block also its W_UK / W_UV operands) to bfloat16 from
  float32 values that agree to ~5e-7 relative, which flips a few of those
  roundings (2**-8 relative); each flip moves a whole token row;
* whole-model logits: the same, with equal argmax; the MoE aux loss at
  1e-4 relative, since its router probabilities inherit those flips;
* the engines' ckv / krope pages, as ``tests/test_torch_engine.py`` holds
  GQA's K/V: layer 0 at 1e-5, all layers at 1e-2 in the worst element and
  1e-5 in the median.

The JAX engine runs its plain path (``use_kernel=False``): it refuses its
Pallas kernel for MLA, and its MLA decode gives an idle row zeros, as the
port's does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core.distkv.dist_attention import attention_partial as \
    jax_attention_partial
from repro.core.distkv.dist_attention import merge_partials_tree as \
    jax_merge_partials_tree
from repro.core.scheduling.request import Request as JaxRequest
from repro.models import Model as JaxModel
from repro.models import attention as jattn
from repro.models.transformer import stack_plan as jax_stack_plan
from repro.serving.api import LLMService as JaxService
from repro.serving.api import SamplingParams as JaxParams
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedEngine as JaxEngine

from repro_torch.bridge import from_numpy_tree, init_params, to_numpy_tree
from repro_torch.configs import ArchConfig, get_config, \
    reference_fields, smoke_config
from repro_torch.core.distkv.dist_attention import (attention_partial,
                                                    merge_partials_tree)
from repro_torch.core.scheduling.request import Request
from repro_torch.models import attention as tattn
from repro_torch.models.transformer import Model, layer_params, stack_plan
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.api import LLMService, SamplingParams
from repro_torch.serving.engine import EngineConfig, PagedEngine

ARCH = "deepseek-v2-236b"
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
PS = 8


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _port_cfg(jcfg):
    return ArchConfig(**dataclasses.asdict(jcfg))


def _jcfg(**kw):
    return dataclasses.replace(jax_smoke_config(ARCH), **kw)


def _model(jcfg, seed=0):
    """The JAX params of ``jcfg`` and the same tree in torch."""
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(seed))
    return jparams, from_numpy_tree(jax.tree.map(np.asarray, jparams))


def _assert_block_close(got, want, dtype):
    """A whole MLA block at the module docstring's tolerance (a flipped
    bf16 rounding of a key moves every later row; one smoke block flips 17
    of its 41k q / k / v elements)."""
    if dtype == "bfloat16":
        np.testing.assert_allclose(_np(got.float()), _np(want),
                                   **TOL[dtype])
        return
    d = np.abs(_np(got) - _np(want))
    assert d.max() <= 1e-2 and np.median(d) <= 1e-4, (d.max(), np.median(d))


def _x(jcfg, shape, seed):
    """An input of ``shape`` in the config's type, for both packages."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, jcfg.param_dtype)
    return jx, from_numpy_tree(np.asarray(jx))


# -- the config, the plan and the weights -------------------------------------

def test_deepseek_config_plan_and_smoke_config():
    """The published widths, the reference's plan (one dense layer, then
    MoE) and the smoke config's MLA and MoE reductions, field for field."""
    full = get_config(ARCH)
    assert reference_fields(full) == dataclasses.asdict(
        jax_get_config(ARCH))
    assert (full.d_model, full.num_heads, full.q_lora_rank,
            full.kv_lora_rank, full.qk_nope_head_dim, full.qk_rope_head_dim,
            full.v_head_dim, full.num_experts, full.moe_top_k,
            full.num_shared_experts) == \
        (5120, 128, 1536, 512, 128, 64, 128, 160, 6, 2)
    plan = [(s.n, s.mixer, s.mlp_kind, s.attn_kind) for s in stack_plan(full)]
    assert plan == [(1, "mla", "dense", "global"),
                    (59, "mla", "moe", "global")]
    assert plan == [(s.n, s.mixer, s.mlp_kind, s.attn_kind)
                    for s in jax_stack_plan(jax_get_config(ARCH))]
    smoke = smoke_config(ARCH)
    assert reference_fields(smoke) == dataclasses.asdict(
        jax_smoke_config(ARCH))
    assert (smoke.num_layers, smoke.d_model, smoke.num_heads,
            smoke.kv_lora_rank, smoke.q_lora_rank, smoke.qk_nope_head_dim,
            smoke.qk_rope_head_dim, smoke.v_head_dim, smoke.num_experts,
            smoke.moe_top_k, smoke.num_shared_experts,
            smoke.capacity_factor) == \
        (2, 256, 4, 64, 96, 32, 16, 32, 4, 2, 1, 4.0)


@pytest.mark.parametrize("q_lora", [96, 0])
def test_init_params_mla_tree_matches_reference(q_lora):
    """``init_params`` gives the JAX ``Model.init`` tree (paths, shapes and
    types), with the low-rank query path or one ``wq``, a stacked MoE
    segment (3 layers), and ``mla_init``'s distributions; the JAX tree
    carries over through the bridge unchanged."""
    jcfg = _jcfg(q_lora_rank=q_lora, num_layers=3)
    jparams, bridged = _model(jcfg)
    tparams = init_params(_port_cfg(jcfg), seed=0, device="cpu")
    ja = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for tree in (tparams, bridged):
        tb = jax.tree_util.tree_flatten_with_path(to_numpy_tree(tree))[0]
        assert [p for p, _ in ja] == [p for p, _ in tb]
        for (_, a), (_, b) in zip(ja, tb):
            assert a.shape == b.shape
            assert b.dtype == (np.uint16 if a.dtype.name == "bfloat16"
                               else a.dtype)
    a = tparams["segments"][1]["attn"]
    assert ("wq_a" in a) == bool(q_lora) and ("wq" in a) != bool(q_lora)
    assert tuple(a["wkv_a"]["w"].shape) == (2, 256, 64 + 16)
    assert tuple(a["wkv_b"]["w"].shape) == (2, 64, 4 * (32 + 32))
    assert abs(a["wkv_b"]["w"].float().std().item() * 8 - 1.0) < 0.05
    assert abs(a["wo"]["w"].float().std().item() * np.sqrt(128) - 1.0) \
        < 0.05
    assert torch.equal(a["kv_norm"]["scale"], torch.ones(2, 64,
                                                         dtype=torch.bfloat16))


# -- MLA functions ------------------------------------------------------------

def _attn_params(jcfg, jparams, tparams, seg):
    """The first layer of segment ``seg`` (0: the dense layer, 1: MoE)."""
    jp = jparams["segments"][seg]
    tp = tparams["segments"][seg]
    if jax_stack_plan(jcfg)[seg].n > 1:
        jp = jax.tree.map(lambda a: a[0], jp)
        tp = layer_params(tp, 0)
    return jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_lora", [96, 0])
def test_mla_forward_matches_jax(q_lora, dtype):
    """The decompressed full-sequence block, both query paths."""
    jcfg = _jcfg(q_lora_rank=q_lora, dtype=dtype)
    jparams, tparams = _model(jcfg, seed=1)
    jp, tp = _attn_params(jcfg, jparams, tparams, 0)
    jx, tx = _x(jcfg, (2, 24, 256), seed=2)
    pos = np.arange(24)
    want = jattn.mla_forward(jcfg, jp["attn"], jx, jnp.asarray(pos))
    got = tattn.mla_forward(_port_cfg(jcfg), tp["attn"], tx, _t(pos))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _assert_block_close(got, want, dtype)


def test_mla_absorb_and_effective_kv_match_jax():
    jcfg = _jcfg(dtype="float32")
    jparams, tparams = _model(jcfg, seed=3)
    jp, tp = _attn_params(jcfg, jparams, tparams, 1)
    tcfg = _port_cfg(jcfg)
    for got, want in zip(tattn.mla_absorb(tcfg, tp["attn"]),
                         jattn.mla_absorb(jcfg, jp["attn"])):
        assert got.shape == want.shape
        np.testing.assert_array_equal(_np(got), _np(want))
    rng = np.random.default_rng(4)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((2, 5, 4, 64), (2, 5, 4, 16), (2, 9, 64), (2, 9, 16))]
    got = tattn.mla_effective_kv(*map(_t, arrays))
    want = jattn.mla_effective_kv(*map(jnp.asarray, arrays))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(_np(g), _np(w))
    assert (got[2][..., 64:] == 0).all()  # values padded with zeros
    assert tattn._mla_scale(tcfg) == jattn._mla_scale(jcfg) == \
        1.0 / np.sqrt(32 + 16)


def _latent_attend(jcfg, q_offset, attention):
    """An ``attend_latent`` over this call's own latent (causal, at
    ``q_offset``) through ``mla_effective_kv`` + ``blockwise_attention``,
    scaled by ``_mla_scale``, all of the package ``attention`` belongs
    to."""
    r = jcfg.kv_lora_rank
    mod = tattn if attention is tattn.blockwise_attention else jattn
    scale = mod._mla_scale(jcfg)

    def attend(q_lat, qr, ckv, krope):
        q_eff, k_eff, v_eff = mod.mla_effective_kv(q_lat, qr, ckv, krope)
        ctx = attention(q_eff, k_eff, v_eff, causal=True, q_offset=q_offset,
                        scale=scale)
        return ctx[..., :r]
    return attend


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seg", [0, 1])
def test_mla_layer_matches_jax(seg, dtype):
    """The absorbed layer (the engine's), dense (segment 0) and MoE
    (segment 1, through ``moe_forward``), with an attend_latent built from
    ``mla_effective_kv`` + ``blockwise_attention``."""
    from repro.models import moe as jmoe

    from repro_torch.models import moe as tmoe
    jcfg = _jcfg(dtype=dtype)
    tcfg = _port_cfg(jcfg)
    jparams, tparams = _model(jcfg, seed=5)
    jp, tp = _attn_params(jcfg, jparams, tparams, seg)
    jx, tx = _x(jcfg, (2, 20, 256), seed=6)
    pos = np.arange(20)
    jmlp = tmlp = None
    if seg == 1:
        def jmlp(p, h):
            return jmoe.moe_forward(jcfg, p, h)

        def tmlp(p, h):
            return tmoe.moe_forward(tcfg, p, h)

    want, _ = jattn.mla_layer(
        jcfg, jp, jx, jnp.asarray(pos),
        lambda *a: (_latent_attend(jcfg, 0, jattn.blockwise_attention)(*a),
                    None), mlp_fn=jmlp)
    got = tattn.mla_layer(tcfg, tp, tx, _t(pos),
                          _latent_attend(jcfg, 0,
                                         tattn.blockwise_attention), tmlp)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _assert_block_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absorbed_layer_matches_decompressed_layer(dtype):
    """The absorbed layer and ``mla_forward``'s decompressed one compute
    the same function: they differ only by where each rounds to bf16 (well
    inside 2**-6 of the output's size), not by a scale (``1/sqrt(r + dr)``
    in place of ``1/sqrt(dn + dr)`` moves every output by far more)."""
    from repro_torch.models.transformer import mla_forward_layer
    jcfg = _jcfg(dtype=dtype)
    tcfg = _port_cfg(jcfg)
    _, tparams = _model(jcfg, seed=7)
    tp = tparams["segments"][0]
    _, tx = _x(jcfg, (1, 24, 256), seed=8)
    pos = torch.arange(24)
    absorbed = tattn.mla_layer(tcfg, tp, tx, pos, _latent_attend(
        jcfg, 0, tattn.blockwise_attention)) - tx
    decompressed = mla_forward_layer(tcfg, tp, tx, pos) - tx
    d = (absorbed.float() - decompressed.float()).abs().max().item()
    assert d <= 2.0 ** -6 * decompressed.float().abs().max().item(), d


@pytest.mark.parametrize("masked_row", [False, True])
def test_attention_partial_and_merge_match_jax(masked_row):
    """One partial, and two over disjoint key sets merged, against the
    reference, in float32; a fully masked query row gives zeros, not
    NaN."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 3, 8, 40)).astype(np.float32)
    k = rng.standard_normal((2, 30, 2, 40)).astype(np.float32)
    v = rng.standard_normal((2, 30, 2, 40)).astype(np.float32)
    mask = rng.random((2, 3, 30)) < 0.7
    if masked_row:
        mask[1, 2] = False
    halves = [slice(0, 13), slice(13, 30)]
    tparts = [attention_partial(_t(q), _t(k[:, h]), _t(v[:, h]),
                                      _t(mask[:, :, h]), scale=0.2)
              for h in halves]
    jparts = [jax_attention_partial(jnp.asarray(q), jnp.asarray(k[:, h]),
                                      jnp.asarray(v[:, h]),
                                      jnp.asarray(mask[:, :, h]), scale=0.2)
              for h in halves]
    for tp, jp in zip(tparts, jparts):
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(_np(a), _np(b), **TOL["float32"])
    got = merge_partials_tree(*zip(*tparts))
    want = jax_merge_partials_tree(*zip(*jparts))
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    whole = merge_partials_tree(*zip(attention_partial(
        _t(q), _t(k), _t(v), _t(mask), scale=0.2)))
    np.testing.assert_allclose(_np(got), _np(whole), **TOL["float32"])
    assert torch.isfinite(got).all()
    if masked_row:
        assert (got[1, 2] == 0).all()


@pytest.mark.parametrize("layers", [2, 3])
def test_model_forward_matches_jax(layers):
    """Teacher-forced logits and the aux loss, float32: the dense layer and
    one MoE layer, or two (a stacked MLA segment, indexed)."""
    jcfg = _jcfg(dtype="float32", logits_fp32=True, num_layers=layers)
    jparams, tparams = _model(jcfg, seed=10)
    toks = np.random.default_rng(11).integers(0, 512, (2, 40))
    want, want_aux = JaxModel(jcfg, remat=False).forward(jparams,
                                                         jnp.asarray(toks))
    got, aux = Model(_port_cfg(jcfg)).forward(tparams, torch.from_numpy(toks))
    assert got.shape == (2, 40, 512)
    d = np.abs(_np(got) - _np(want))
    assert d.max() <= 1e-2 and np.median(d) <= 1e-4, (d.max(), np.median(d))
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))
    assert float(want_aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-4)


# -- the MLA engine -----------------------------------------------------------

@pytest.fixture(scope="module")
def mla_f32():
    jcfg = _jcfg(dtype="float32", logits_fp32=True)
    jparams, tparams = _model(jcfg, seed=0)
    return jcfg, jparams, tparams


def _engines(setup, **kw):
    jcfg, jparams, tparams = setup
    kw.setdefault("num_pages", 64)
    kw.setdefault("page_size", PS)
    kw.setdefault("max_slots", 4)
    je = JaxEngine(jcfg, jparams, JaxEngineConfig(use_kernel=False, **kw))
    te = PagedEngine(_port_cfg(jcfg), tparams, EngineConfig(**kw),
                     device="cpu")
    return je, te


def _assert_pools_close(je, te):
    """The ckv and krope pages, the trash page left out."""
    P = je.ecfg.num_pages
    for jp, tp in ((je.k_pages, te.k_pages), (je.v_pages, te.v_pages)):
        a = np.asarray(jp)[:, :P]
        b = tp[:, :P].numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(b[0], a[0], rtol=1e-5, atol=1e-5)
        d = np.abs(a - b)
        assert d.max() <= 1e-2 and np.median(d) <= 1e-5, \
            (d.max(), np.median(d))
    assert np.abs(te.k_pages[:, :P].numpy()).max() > 0


def _run_both(je, te, plan):
    """``plan``: [(steps to run first, [(prompt, max_new)])]; each batch
    joins after its steps, then both engines run to completion."""
    out = []
    for eng, R in ((je, JaxRequest), (te, Request)):
        reqs = []
        for steps, batch in plan:
            for _ in range(steps):
                eng.step()
            for prompt, max_new in batch:
                reqs.append(R(len(reqs), 0.0, list(prompt),
                              max_new_tokens=max_new))
                eng.add_request(reqs[-1])
        eng.run_to_completion()
        out.append(reqs)
    assert te.iterations == je.iterations
    max_new = [m for _, batch in plan for _, m in batch]
    for a, b, m in zip(*out, max_new):
        assert len(b.full_output) == m
        assert b.full_output == a.full_output, b.request_id
    return out


def test_mla_engine_pools_follow_layout(mla_f32):
    """``KVPageLayout``'s MLA schema: ckv (L, P+1, ps, r) and krope (L,
    P+1, ps, dr) pools, as ``tests/test_mla.py`` has the reference's."""
    je, te = _engines(mla_f32, num_pages=48)
    lay = te.kv_layout
    assert lay.flavor == te.flavor == "mla"
    assert lay.schema == je.kv_layout.schema == "mla:ckv64+krope16:f32"
    shapes = lay.pool_shapes(48 + 1, PS)
    assert tuple(te.k_pages.shape) == shapes[0] == (2, 49, PS, 64)
    assert tuple(te.v_pages.shape) == shapes[1] == (2, 49, PS, 16)
    assert te.allocator.page_bytes == lay.page_bytes(PS)
    bf16 = PagedEngine(smoke_config(ARCH), init_params(
        smoke_config(ARCH), seed=0, device="cpu"), EngineConfig(
            num_pages=8, page_size=PS), device="cpu")
    assert bf16.kv_layout.schema == "mla:ckv64+krope16:bf16"
    assert bf16.k_pages.dtype == torch.bfloat16


def test_mla_engine_refuses_a_sliding_window(mla_f32):
    jcfg, _, tparams = mla_f32
    cfg = dataclasses.replace(_port_cfg(jcfg), sliding_window=16)
    with pytest.raises(ValueError, match="sliding window"):
        PagedEngine(cfg, tparams, EngineConfig(num_pages=8, page_size=PS),
                    device="cpu")


def test_mla_engine_chunked_prefill_matches_jax(mla_f32, monkeypatch):
    """Chunks of a 12-token budget (chunk starts off the 8-token page
    boundary: 12, 24, 36), a late join while the others decode, idle rows
    in the decode batch. The MLA path calls neither attention kernel's
    wrapper: both are replaced by functions that raise."""
    def refuse(*args, **kwargs):
        raise AssertionError("the MLA path called a GQA kernel wrapper")

    monkeypatch.setattr(engine_mod, "paged_attention", refuse)
    monkeypatch.setattr(engine_mod, "prefill_attention_paged", refuse)
    je, te = _engines(mla_f32, max_tokens_per_iter=12)
    rng = np.random.default_rng(3)
    p = [rng.integers(0, 512, n).tolist() for n in (43, 6, 17)]
    _run_both(je, te, [(0, [(p[0], 6), (p[1], 7)]), (3, [(p[2], 5)])])
    assert te.prefill_chunks >= 6
    _assert_pools_close(je, te)


def test_mla_engine_best_of_n_cow_fork_matches_jax(mla_f32):
    """Greedy best-of-2 through LLMService: the sibling is COW-forked off
    the parent's prefill (the shared partial page copied on write) and
    both samples equal the JAX engine's."""
    je, te = _engines(mla_f32)
    cows = []
    schedule = te.scheduler.schedule

    def recording():
        plan = schedule()
        cows.extend(plan.cow)
        return plan

    te.scheduler.schedule = recording
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, n).tolist() for n in (11, 6)]
    want = JaxService(je).generate(prompts, JaxParams(max_new_tokens=5, n=2))
    got = LLMService(te).generate(prompts, SamplingParams(max_new_tokens=5,
                                                          n=2))
    for g, w in zip(got, want):
        assert [s.token_ids for s in g.samples] == \
            [s.token_ids for s in w.samples]
    assert cows, "the shared partial page must be copied on write"
    assert te.allocator.num_free == te.allocator.num_blocks
    _assert_pools_close(je, te)


def test_mla_engine_prefix_cache_hit_matches_jax(mla_f32):
    """A second prompt sharing 20 tokens (2 pages + 4) with a finished one
    resumes its prefill mid-page from the cached latent pages."""
    je, te = _engines(mla_f32, enable_prefix_cache=True)
    rng = np.random.default_rng(13)
    common = rng.integers(0, 512, 20).tolist()
    a = common + rng.integers(0, 512, 6).tolist()
    b = common + rng.integers(0, 512, 9).tolist()
    jr, tr = _run_both(je, te, [(0, [(a, 2)])])
    outs = []
    for eng, R in ((je, JaxRequest), (te, Request)):
        req = R(1, 0.0, b, max_new_tokens=4)
        eng.add_request(req)
        eng.run_to_completion()
        assert req.num_cached_tokens == 20
        outs.append(req.full_output)
    assert outs[1] == outs[0]
    _assert_pools_close(je, te)


def test_mla_engine_preemption_matches_jax(mla_f32):
    """A 10-page pool too small for three 30-token prompts decoding 14
    tokens each: a request is preempted and recomputed, alike in both."""
    je, te = _engines(mla_f32, num_pages=10, max_slots=3)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 512, 30).tolist() for _ in range(3)]
    _run_both(je, te, [(0, [(p, 14) for p in prompts])])
    assert te.preemptions == je.preemptions > 0


def test_launcher_serves_deepseek_reduced_on_cpu():
    from repro_torch.launch import serve
    stats = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--requests", "3", "--rate", "100", "--pages", "32",
                        "--page-size", "8", "--slots", "2", "--max-new", "4"])
    assert stats.n_finished == stats.n_requests == 3
