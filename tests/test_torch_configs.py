"""The port's ``PagedEngine`` against the JAX ``PagedEngine`` on the GQA
configs, at smoke size, in float32 (``logits_fp32``): the
same requests on the same weights (carried over by the bridge) must give
identical greedy tokens.

The dense configs bring what danube's tests do not: OPT's biases, its
non-gated tanh-GELU MLP and tied embedding, granite's MQA (4 query heads
on one KV head at smoke size) and large RoPE bases. The llama4 case is MoE
on GQA at capacity factor 1.0, so tokens are dropped, with 16 slots, and a
chunk budget that gives chunks whose lengths are not powers of two. Two
things must then follow the reference exactly, or routing diverges:

* every decode row is routed, the rows that are not decoding too. The
  reference feeds them token 0 at position 0 (``repro/serving/engine.py:
  663-669, 920``); ten idle rows ahead of the six decoding ones take
  places in the experts before them;
* a prefill chunk's capacity is that of its power-of-two bucket
  (``engine.py:876``): a 70-token chunk has 32 places per expert, not 24.

The JAX engine runs its Pallas decode kernel here (``use_kernel``, in
interpret mode): its plain decode attention returns NaN for the rows that
are not decoding, which ``lax.top_k`` then routes to expert 0, where the
Pallas kernel, like the port's kernel and plain version, returns zeros.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core.scheduling.request import Request as JaxRequest
from repro.models import Model as JaxModel
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedEngine as JaxEngine

from repro_torch.bridge import from_numpy_tree
from repro_torch.configs import ARCH_IDS, ArchConfig, get_config
from repro_torch.core.scheduling.request import Request
from repro_torch.serving.engine import EngineConfig, PagedEngine

LLAMA4 = "llama4-scout-17b-a16e"


def _engines(arch, seed, *, use_kernel=False, max_seq=None, **ecfg):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               logits_fp32=True)
    if jcfg.is_moe:
        jcfg = dataclasses.replace(jcfg, capacity_factor=1.0)
    if max_seq:
        jcfg = dataclasses.replace(jcfg, max_seq_len=max_seq)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(seed))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams))
    je = JaxEngine(jcfg, jparams, JaxEngineConfig(use_kernel=use_kernel,
                                                  **ecfg))
    te = PagedEngine(ArchConfig(**dataclasses.asdict(jcfg)), tparams,
                     EngineConfig(**ecfg), device="cpu")
    return je, te


def _run(eng, R, plan):
    """``plan``: (steps to run first, [(prompt, max_new)]) in turns; each
    batch of requests joins after its steps; then run to completion."""
    reqs = []
    for steps, batch in plan:
        for _ in range(steps):
            eng.step()
        for prompt, max_new in batch:
            reqs.append(R(len(reqs), 0.0, list(prompt),
                          max_new_tokens=max_new))
            eng.add_request(reqs[-1])
    eng.run_to_completion()
    return reqs


@pytest.mark.parametrize("arch", ["paper-opt-13b", "granite-20b",
                                  "command-r-35b", "mistral-large-123b",
                                  "internvl2-26b"])
def test_dense_engine_matches_jax_engine(arch):
    """Chunked prefill (a 16-token budget), a late join while the others
    decode, and a mid-page prompt end. internvl2-26b is served text-only,
    as the reference's engine serves it (neither engine takes media)."""
    je, te = _engines(arch, 0, num_pages=64, page_size=8, max_slots=4,
                      max_tokens_per_iter=16)
    rng = np.random.default_rng(3)
    p = [rng.integers(0, 512, n).tolist() for n in (29, 6, 13)]
    plan = [(0, [(p[0], 5), (p[1], 6)]), (3, [(p[2], 4)])]
    jr, tr = _run(je, JaxRequest, plan), _run(te, Request, plan)
    assert te.iterations == je.iterations
    for a, b in zip(jr, tr):
        assert len(b.full_output) == b.max_new_tokens
        assert b.full_output == a.full_output, (arch, b.request_id)


def test_llama4_engine_routes_as_jax_engine():
    """16 slots: ten short requests take slots 0-9 and finish while six
    long ones (150-token prompts, chunked by an 80-token budget shared with
    the decodes into chunks of 20-79 tokens) decode in slots 10-15 behind
    ten idle rows; a late request then joins a freed slot. Capacity factor
    1.0: decode rows have 8 places per expert, a 70-token chunk 32. The
    context limit (176) keeps the interpreted Pallas kernel's block tables
    narrow."""
    je, te = _engines(LLAMA4, 4, use_kernel=True, max_seq=176,
                      num_pages=256, page_size=8, max_slots=16,
                      max_tokens_per_iter=80)
    rng = np.random.default_rng(11)
    short = [(rng.integers(0, 512, 6).tolist(), 2) for _ in range(10)]
    long = [(rng.integers(0, 512, 150).tolist(), 10) for _ in range(6)]
    late = [(rng.integers(0, 512, 21).tolist(), 6)]
    plan = [(0, short + long), (14, late)]
    jr, tr = _run(je, JaxRequest, plan), _run(te, Request, plan)
    assert te.iterations == je.iterations
    for a, b in zip(jr, tr):
        assert len(b.full_output) == b.max_new_tokens
        assert b.full_output == a.full_output, b.request_id


def test_llama4_engine_matches_model_forward_without_drops():
    """At the smoke capacity factor (E / top_k: no token dropped) the
    chunked, paged engine routes every token as the monolithic
    ``Model.forward`` does: greedy tokens equal its argmax over prompt +
    generated tokens (float32), with a best-of-2 request COW-forked and a
    prompt chunked by a 32-token budget."""
    import torch

    from repro_torch.bridge import init_params
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import Model
    from repro_torch.serving.api import LLMService, SamplingParams

    cfg = dataclasses.replace(smoke_config(LLAMA4), dtype="float32",
                              logits_fp32=True)
    params = init_params(cfg, seed=2, device="cpu")
    engine = PagedEngine(cfg, params, EngineConfig(
        num_pages=64, page_size=8, max_slots=4, max_tokens_per_iter=32),
        device="cpu")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 512, n).tolist() for n in (70, 9)]
    outs = LLMService(engine).generate(prompts, SamplingParams(
        max_new_tokens=6, n=2))
    assert engine.prefill_chunks >= 4
    model = Model(cfg)
    for prompt, out in zip(prompts, outs):
        for sample in out.samples:
            toks = sample.token_ids
            logits, _ = model.forward(params, torch.tensor(
                [prompt + toks[:-1]]))
            want = logits[0, len(prompt) - 1:, :cfg.vocab_size].argmax(-1)
            assert toks == want.tolist()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_family_predicates_match_reference(arch):
    """``is_ssm_only``, ``is_moe``, ``is_hybrid`` and ``is_encdec`` of every
    arch the port knows, against the JAX config's."""
    mine, ref = get_config(arch), jax_get_config(arch)
    for name in ("is_ssm_only", "is_moe", "is_hybrid", "is_encdec"):
        assert getattr(mine, name) == getattr(ref, name), name
