"""The paged GQA decode step's piecewise graphs
(``repro_torch.serving.decode_graphs``) on the CPU: which steps take them,
and the pieces, run eagerly in the graphs' order, against the engine's
eager layers bit for bit, through rows joining and leaving, block tables
widening over page boundaries, a preemption with recompute and a COW
fork. No JAX: ``tests/test_torch_cuda.py`` runs the same scenario on the
card, where the pieces are CUDA graphs."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import init_params
from repro_torch.configs import smoke_config
from repro_torch.serving.api import LLMService, SamplingParams
from repro_torch.serving.engine import EngineConfig, PagedEngine

# a pool of 14 pages of 8 (112 tokens) under four rows whose contexts
# grow to 25-86 tokens: the scheduler preempts and recomputes
ECFG = dict(num_pages=14, page_size=8, max_slots=4, max_tokens_per_iter=40)
FIRST = ((9, 16), (40, 30), (30, 30))
LATE = 70
ARCHS = ["paper-opt-13b", "h2o-danube-1.8b"]  # danube: a window of 64


def checked_against_eager(engine):
    """Wrap ``engine._decode`` so that each step first runs the eager
    oracle (``eager=True``) on the same state, then, from the state before
    it, the step's own path, and holds the logits and the pools it leaves
    to the oracle's bit for bit. Returns the list of steps it checked
    (the graphed path's flag of each)."""
    decode = engine._decode
    checked = []

    def step(*args, **kwargs):
        pools = (engine.k_pages, engine.v_pages)
        before = [p.clone() for p in pools]
        want = decode(*args, eager=True, **kwargs).clone()
        wrote = [p.clone() for p in pools]
        for p, b in zip(pools, before):
            p.copy_(b)
        graphed = engine.graph_decode_steps
        got = decode(*args, **kwargs)
        checked.append(engine.graph_decode_steps > graphed)
        assert torch.equal(got, want), (got.float() - want.float()).abs().max()
        for p, w in zip(pools, wrote):
            assert torch.equal(p, w)
        return got
    engine._decode = step
    return checked


def serve_scenario(engine):
    """Rows join (requests submitted after others decode) and leave
    (replies of 6-30 tokens), block tables widen past page boundaries,
    the pool forces preemptions, and a best-of-2 request forks its
    prompt's pages (COW). Returns the service's outputs."""
    rng = np.random.default_rng(7)
    svc = LLMService(engine)
    first = [svc.submit(rng.integers(0, 500, n).tolist(),
                        SamplingParams(max_new_tokens=m))
             for n, m in FIRST]
    for _ in range(3):
        svc.poll()
    late = [svc.submit(rng.integers(0, 500, LATE).tolist(),
                       SamplingParams(max_new_tokens=16)),
            svc.submit(rng.integers(0, 500, 20).tolist(),
                       SamplingParams(max_new_tokens=6, n=2,
                                      temperature=0.9, seed=3))]
    while svc.pending:
        svc.poll()
    return [svc._take_result(rid) for rid in first + late]


def engine_on(arch, dev, **kw):
    cfg = smoke_config(arch)
    params = init_params(cfg, 0, device=dev)
    return PagedEngine(cfg, params, EngineConfig(**ECFG, **kw), device=dev)


@pytest.mark.parametrize("arch", ARCHS)
def test_pieces_equal_the_eager_layers(arch, monkeypatch):
    """The graphed branch of ``_decode`` with its pieces run eagerly (the
    CPU has no graphs; the path choice is forced) against the eager
    layers: the same logits and the same pool writes on every step."""
    engine = engine_on(arch, "cpu")
    monkeypatch.setattr(engine, "_eager_reason", lambda n, remote: None)
    checked = checked_against_eager(engine)
    outs = serve_scenario(engine)
    assert engine.preemptions > 0
    assert [len(s.token_ids) for o in outs for s in o.samples] == \
        [16, 30, 30, 16, 6, 6]
    assert len(checked) >= 20 and all(checked)
    assert engine.graph_decode_steps == len(checked)
    assert engine.decode_steps == 2 * len(checked)
    assert engine._graphs.graphs is None  # no capture off the card


# one creditor's (home, block tables, context lengths)
REMOTE = [(1, np.zeros((4, 1), np.int32), np.zeros(4, np.int32))]


@pytest.mark.parametrize("arch,rows,remote,reason", [
    ("paper-opt-13b", 4, False, "cpu"),
    ("paper-opt-13b", 3, False, "rows"),
    ("paper-opt-13b", 4, True, "remote partials"),
    ("h2o-danube-1.8b", 4, False, "cpu"),
    ("deepseek-v2-236b", 4, False, "mla"),
    ("llama4-scout-17b-a16e", 4, False, "moe MLP"),
])
def test_the_path_choice(arch, rows, remote, reason):
    """The graphs hold a dense GQA step on the card at the engine's slots
    with no remote partials; every other step names why it runs eagerly:
    the CPU, another row count, remote partials, MLA, MoE."""
    cfg = smoke_config(arch)
    engine = PagedEngine(cfg, init_params(cfg, 0, device="cpu"),
                         EngineConfig(**ECFG), device="cpu")
    got = engine._eager_reason(rows, REMOTE if remote else ())
    assert got == reason


def test_no_step_is_graphed_on_the_cpu():
    engine = engine_on("paper-opt-13b", "cpu")
    serve_scenario(engine)
    assert engine.decode_steps > 0 and engine.graph_decode_steps == 0
    assert engine._graphs is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_writes_into_out(dtype):
    """``out=`` receives the result that the call would return, and is
    what it returns; a wrong ``out`` raises."""
    from repro_torch.kernels.paged_attention import paged_attention
    g = torch.Generator().manual_seed(0)
    q = torch.randn(3, 4, 16, generator=g).to(dtype)
    kp = torch.randn(6, 8, 2, 16, generator=g).to(dtype)
    vp = torch.randn(6, 8, 2, 16, generator=g).to(dtype)
    bt = torch.tensor([[0, 1], [2, 3], [4, 5]], dtype=torch.int32)
    lens = torch.tensor([9, 0, 16], dtype=torch.int32)
    want = paged_attention(q, kp, vp, bt, lens, page_size=8)
    out = torch.full_like(q, 7.0)
    got = paged_attention(q, kp, vp, bt, lens, page_size=8, out=out)
    assert got is out and torch.equal(out, want)
    for bad in (out[:2], out.float() if dtype != torch.float32
                else out.double(), out.transpose(0, 1).contiguous()
                .transpose(0, 1)):
        with pytest.raises(ValueError, match="out must be"):
            paged_attention(q, kp, vp, bt, lens, page_size=8, out=bad)


def test_the_layer_halves_compose_to_the_layer():
    """``gqa_layer`` is ``gqa_layer_out`` of its attention of
    ``gqa_layer_qkv``: the engine's eager layers and the pieces run one
    body."""
    from repro_torch.models.attention import (gqa_layer, gqa_layer_out,
                                              gqa_layer_qkv)
    from repro_torch.models.transformer import Model
    cfg = dataclasses.replace(smoke_config("paper-opt-13b"),
                              dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    _, _, p = next(Model(cfg).layers(params))
    x = torch.randn(3, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    pos = torch.arange(5)
    seen = []

    def attend(q, k, v):
        seen.append((q, k, v))
        return q * 0.5
    y = gqa_layer(cfg, p, x, pos, attend)
    q, k, v = gqa_layer_qkv(cfg, p, x, pos)
    assert all(torch.equal(a, b) for a, b in zip(seen[0], (q, k, v)))
    assert torch.equal(y, gqa_layer_out(cfg, p, x, q * 0.5))
