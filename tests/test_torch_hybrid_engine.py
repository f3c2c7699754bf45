"""The paged engine on a stack of Mamba-2 and GQA layers (granite-4.0-h-
small's ``layer_types``), at a smoke width in float32 on the CPU, against
``Model.forward`` on the same weights: [ssm, ssm, gqa, ssm], each with a
MoE of 8 experts (top 2) and a shared MLP, NoPE attention at granite's
softmax scale, its embedding, residual and logits multipliers.

Every token the engine samples comes from logits (prefill chunk or decode
row), each recorded at its absolute position and compared with the
teacher-forced forward over the request's whole sequence. Prompts are
split into chunks of a 24-token budget (boundaries at 24 and 48, no
multiple of the 16-token ``ssm_chunk``; ragged last chunks), decode rows
ride beside rows still in prefill, a tight page pool preempts, and one
slot serves requests in turn.

Tolerance: the engine's decode attention (``paged_attention``'s plain
version) is float32 throughout, while ``Model.forward``'s
``blockwise_attention`` rounds q, k, v and the probabilities to bfloat16;
the SSM paths (the chunked scan from a carried state against the forward's
one scan; the in-place recurrent step against the scan) differ by float32
rounding only. Over these prompts the largest difference is below 1e-3 of
the largest |logit| (``LOGIT_TOL`` is ten times that); a state that is not
carried, or carried from another request, moves the logits by their whole
size.

The C5 repair: ``Model.prefill`` of mamba2 and hymba at smoke width takes
a prompt that is no multiple of ``ssm_chunk`` (the scan's short last
chunk), held to the same model stepped token by token from empty caches
(``Model.decode_step``: the sequential recurrence) to float32 rounding.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import init_params
from repro_torch.configs import get_config, smoke_config
from repro_torch.models.transformer import Model, stack_plan
from repro_torch.serving.api import LLMService, SamplingParams
from repro_torch.serving.engine import EngineConfig, PagedEngine

LOGIT_TOL = 1e-2  # of the largest |logit| (see the module docstring)
LAYERS = ("mamba", "mamba", "attention", "mamba")


@pytest.fixture(scope="module")
def hybrid():
    cfg = dataclasses.replace(
        get_config("granite-4.0-h-small"), num_layers=4, layer_types=LAYERS,
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        vocab_size=512, num_experts=8, moe_top_k=2, moe_d_ff=32,
        shared_d_ff=48, capacity_factor=4.0, ssm_state=16, ssm_head_dim=16,
        ssm_chunk=16, dtype="float32", logits_fp32=True, max_seq_len=512)
    return cfg, init_params(cfg, seed=3, device="cpu")


def _engine(cfg, params, **kw):
    ecfg = dict(num_pages=96, page_size=8, max_slots=4,
                max_tokens_per_iter=24)
    ecfg.update(kw)
    return PagedEngine(cfg, params, EngineConfig(**ecfg), device="cpu")


def _record(eng):
    """Wrap the engine's sampling: every row's logits, keyed by request id
    and the absolute position they were computed at."""
    seen = []
    sample = eng._sample_rows

    def rows(logits, reqs):
        for i, r in enumerate(reqs):
            if r is not None:
                seen.append((r.request_id, r.context_len - 1,
                             logits[i].clone()))
        return sample(logits, reqs)
    eng._sample_rows = rows
    return seen


def _check(cfg, params, seen, prompts, outs):
    """Each recorded row against the forward over its request's prompt and
    served tokens; returns the largest difference over the largest
    |logit|."""
    model = Model(cfg)
    full = {}
    for p, o in zip(prompts, outs):
        seq = torch.tensor([list(p) + list(o.token_ids)])
        full[o.request_id] = model.forward(params, seq)[0][0]
    worst = 0.0
    for rid, pos, row in seen:
        want = full[rid][pos]
        worst = max(worst, float((row - want).abs().max()
                                 / want.abs().max()))
    return worst


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).tolist() for n in lengths]


def test_plan_and_counts_follow_layer_types(hybrid):
    cfg, _ = hybrid
    assert [(s.n, s.mixer, s.mlp_kind, s.attn_kind)
            for s in stack_plan(cfg)] == [(2, "ssm", "moe", "none"),
                                          (1, "gqa", "moe", "global"),
                                          (1, "ssm", "moe", "none")]
    full = get_config("granite-4.0-h-small")
    assert abs(full.n_params() / 1e9 - 32.2) < 0.05
    assert abs(full.n_active_params() / 1e9 - 8.8) < 0.05
    cut = dataclasses.replace(full, num_layers=30,
                              layer_types=full.layer_types[:30])
    assert abs(cut.n_params() / 1e9 - 24.26) < 0.01
    assert smoke_config("granite-4.0-h-small").layer_types == \
        ("mamba", "attention")


def test_engine_matches_forward_through_chunks_and_mixed_steps(hybrid):
    """Prompts of 50, 13, 70 and 37 tokens over a 24-token budget: chunks
    cut at 24 and 48 and ragged last chunks, the carried state entering
    each later chunk, decode steps with rows still in prefill (the
    in-place step of a subset) and with every slot decoding."""
    cfg, params = hybrid
    eng = _engine(cfg, params)
    seen = _record(eng)
    prompts = _prompts((50, 13, 70, 37), 1)
    outs = LLMService(eng).generate(prompts,
                                    SamplingParams(max_new_tokens=12))
    assert eng.ssm_carried_chunks >= 5
    assert all(len(o.token_ids) == 12 for o in outs)
    assert _check(cfg, params, seen, prompts, outs) < LOGIT_TOL


def test_decode_leaves_rows_in_prefill_bit_equal(hybrid):
    """A decode step with one row decoding, one row between two prefill
    chunks (its carried conv window and state in its slot) and two free:
    the step writes the decoding row's SSM pool rows and leaves every
    other row's as they were, bit for bit."""
    cfg, params = hybrid
    eng = _engine(cfg, params)
    svc = LLMService(eng)
    a, b = _prompts((6, 60), 2)
    svc.submit(a, SamplingParams(max_new_tokens=8))
    svc.poll(0.0)  # a's prefill: one chunk, first token
    svc.submit(b, SamplingParams(max_new_tokens=4))
    decode = eng._decode
    checked = []

    def spy(tokens, positions, block_tables, ctx_lens, *args, **kw):
        idle = np.flatnonzero(np.asarray(ctx_lens) == 0)
        busy = np.flatnonzero(np.asarray(ctx_lens) > 0)
        st0, cv0 = eng.ssm_state.clone(), eng.ssm_conv.clone()
        out = decode(tokens, positions, block_tables, ctx_lens, *args, **kw)
        assert torch.equal(eng.ssm_state[:, idle], st0[:, idle])
        assert torch.equal(eng.ssm_conv[:, idle], cv0[:, idle])
        assert not torch.equal(eng.ssm_state[:, busy], st0[:, busy])
        checked.append(len(busy))
        return out
    eng._decode = spy
    while eng.has_work or svc._queue:
        svc.poll(0.0)
    # b's prefill took three iterations beside a's decodes
    assert eng.ssm_carried_chunks >= 2 and checked.count(1) >= 2


def test_preemption_recomputes_from_a_zero_state(hybrid):
    """A pool too small for every sequence: preemption by recompute, whose
    restart at position 0 starts the slot's SSM rows from zeros."""
    cfg, params = hybrid
    eng = _engine(cfg, params, num_pages=16, max_tokens_per_iter=40)
    seen = _record(eng)
    prompts = _prompts((30, 33, 36, 29), 4)
    outs = LLMService(eng).generate(prompts,
                                    SamplingParams(max_new_tokens=24))
    assert eng.preemptions > 0
    assert _check(cfg, params, seen, prompts, outs) < LOGIT_TOL


def test_slot_reuse_starts_from_zeros(hybrid):
    """One slot serves three requests in turn: each starts from a zero
    state, not from the last one's."""
    cfg, params = hybrid
    eng = _engine(cfg, params, max_slots=1)
    seen = _record(eng)
    prompts = _prompts((20, 35, 9), 5)
    outs = LLMService(eng).generate(prompts,
                                    SamplingParams(max_new_tokens=6))
    assert _check(cfg, params, seen, prompts, outs) < LOGIT_TOL


def test_refuses_what_would_leave_the_state_behind(hybrid):
    cfg, params = hybrid
    with pytest.raises(ValueError, match="prefix cache"):
        _engine(cfg, params, enable_prefix_cache=True)
    with pytest.raises(ValueError, match="host KV tier"):
        _engine(cfg, params, host_pages=8)
    eng = _engine(cfg, params)
    svc = LLMService(eng)
    svc.submit(_prompts((10,), 6)[0], SamplingParams(max_new_tokens=2, n=2))
    with pytest.raises(ValueError, match="best-of-n"):
        svc.poll(0.0)
    with pytest.raises(ValueError, match="zero-copy lease"):
        eng._check_zero_copy_ok()
    with pytest.raises(ValueError, match="KV handoff"):
        eng.release_for_handoff(None)
    with pytest.raises(ValueError, match="KV handoff"):
        eng.install_for_handoff(None, None)
    # an SSM-only or a hybrid-head stack is still not served
    with pytest.raises(ValueError, match="Mamba-2 and GQA"):
        mamba = smoke_config("mamba2-1.3b")
        PagedEngine(mamba, init_params(mamba, seed=0, device="cpu"),
                    EngineConfig(num_pages=8, page_size=8, max_slots=2),
                    device="cpu")


@pytest.mark.parametrize("arch,length", [("mamba2-1.3b", 45),
                                         ("hymba-1.5b", 77)])
def test_model_prefill_takes_a_ragged_prompt(arch, length):
    """The C5 repair: ``Model.prefill`` over a prompt longer than
    ``ssm_chunk`` (32 at smoke width) and no multiple of it, against the
    model stepped token by token from empty caches: the last position's
    logits and every SSM state, to float32 rounding (2e-4 of the largest
    value; hymba's window attention rounds to bfloat16 in both)."""
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                              logits_fp32=True)
    params = init_params(cfg, seed=1, device="cpu")
    model = Model(cfg)
    toks = torch.from_numpy(np.random.default_rng(length).integers(
        0, cfg.vocab_size, (2, length)))
    last, caches = model.prefill(params, toks, seq_capacity=128)
    steps = model.init_cache(2, 128, device="cpu")
    for t in range(length):
        got, steps = model.decode_step(params, toks[:, t:t + 1],
                                       torch.full((2,), t), steps)
    tol = 2e-4 * float(last.abs().max())
    assert float((got - last).abs().max()) <= tol
    for seg, a, b in zip(model.plan, caches, steps):
        if seg.mixer in ("ssm", "hybrid"):
            sa = a.state if seg.mixer == "ssm" else a[1].state
            sb = b.state if seg.mixer == "ssm" else b[1].state
            assert float((sa - sb).abs().max()) <= \
                2e-4 * float(sb.abs().max())


def test_ssm_spans_and_carried_chunks(hybrid):
    """With telemetry on, each SSM layer's mixer is an ``ssm.mixer`` span:
    over an iteration's prefill chunks, packed, holding one ``ssm.scan``
    per chunk (``carried`` where the chunk began from a carried state: as
    many per layer as the engine's ``ssm_carried_chunks``), or over a
    decode step, holding one ``ssm.update`` whose ``active`` counts the
    rows that stepped."""
    cfg, params = hybrid
    eng = _engine(cfg, params, enable_telemetry=True)
    LLMService(eng).generate(_prompts((50, 9), 7),
                             SamplingParams(max_new_tokens=5))
    ev = [e for e in eng.trace.events() if e.ph == "X"]
    scans = [e.args for e in ev if e.name == "ssm.scan"]
    updates = [e.args for e in ev if e.name == "ssm.update"]
    mixers = [e.args for e in ev if e.name == "ssm.mixer"]
    n_ssm = LAYERS.count("mamba")
    assert len(scans) == n_ssm * eng.prefill_chunks
    assert sum(a["carried"] for a in scans) == \
        n_ssm * eng.ssm_carried_chunks > 0
    assert {(a["heads"], a["head_dim"], a["state"], a["groups"])
            for a in scans} == {(8, 16, 16, 1)}
    assert len(updates) == n_ssm * eng.decode_steps
    assert all(a["rows"] == 4 and 1 <= a["active"] <= 2 for a in updates)
    packed = [e.args for e in ev if e.name == "chunk"]
    chunk_mixers = [a for a in mixers if a["phase"] == "chunk"]
    assert len(chunk_mixers) == n_ssm * len(packed)
    assert sum(a["chunks"] for a in packed) == eng.prefill_chunks
    assert any(a["chunks"] > 1 for a in packed)
    assert sum(a["tokens"] for a in chunk_mixers) == \
        n_ssm * sum(a["length"] for a in packed) == n_ssm * (50 + 9)
    assert len(mixers) == len(chunk_mixers) + len(updates)
    assert {a["phase"] for a in mixers} == {"chunk", "decode"}
