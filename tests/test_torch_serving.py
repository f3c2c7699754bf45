"""The port's serving path end to end on the CPU: a sliding-window stack
served by the port's ``PagedEngine`` against the JAX engine and oracle, and
mixed greedy / sampled traffic through ``LLMService``.

Float32 throughout (``logits_fp32``): greedy tokens must be identical to the
JAX engine and to the JAX ``Model`` oracle. Sampled tokens come from the
port's own counter-based stream, so they are held to determinism per
(seed, step), not to JAX's bits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import smoke_config as jax_smoke_config
from repro.core.scheduling.request import Request as JaxRequest
from repro.models import Model as JaxModel
from repro.serving.api import LLMService as JaxService
from repro.serving.api import SamplingParams as JaxParams
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedEngine as JaxEngine

from repro_torch.bridge import from_numpy_tree
from repro_torch.configs import ArchConfig
from repro_torch.core.scheduling.request import Request
from repro_torch.serving.api import LLMService, SamplingParams
from repro_torch.serving.engine import EngineConfig, PagedEngine


def _setup(window, **narrow):
    jcfg = dataclasses.replace(jax_smoke_config("h2o-danube-1.8b"),
                               dtype="float32", logits_fp32=True,
                               sliding_window=window, **narrow)
    jmodel = JaxModel(jcfg, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams))
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg)), jmodel, jparams, \
        tparams


@pytest.fixture(scope="module")
def swa_f32():
    # the smoke window (64) over a narrow stack with the full model's
    # head_dim 80 and 2 KV heads for 4 query heads
    return _setup(64, head_dim=80, num_kv_heads=2)


@pytest.fixture(scope="module")
def global_f32():
    return _setup(None)


def _oracle(jmodel, jparams, prompt, n):
    logits, caches = jmodel.prefill(
        jparams, jnp.asarray(prompt, jnp.int32)[None], seq_capacity=256)
    out = [int(jnp.argmax(logits[0]))]
    pos = len(prompt)
    while len(out) < n:
        lg, caches = jmodel.decode_step(
            jparams, jnp.array([[out[-1]]], jnp.int32),
            jnp.array([pos], jnp.int32), caches)
        out.append(int(jnp.argmax(lg[0])))
        pos += 1
    return out


def _ecfg(**kw):
    kw.setdefault("num_pages", 64)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_slots", 4)
    return kw


def test_sliding_window_prompt_longer_than_window(swa_f32):
    """A 100-token prompt over a 64-token window, chunked at 40 tokens,
    beside a short request, at head_dim 80: the window masks both the
    prefill and the paged decode."""
    jcfg, tcfg, jmodel, jparams, tparams = swa_f32
    kw = _ecfg(max_tokens_per_iter=40)
    je = JaxEngine(jcfg, jparams, JaxEngineConfig(**kw))
    te = PagedEngine(tcfg, tparams, EngineConfig(**kw), device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, n).tolist() for n in (100, 9)]
    outs = []
    for eng, R in ((je, JaxRequest), (te, Request)):
        reqs = [R(i, 0.0, list(p), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.add_request(r)
        eng.run_to_completion()
        outs.append([r.full_output for r in reqs])
    assert outs[1] == outs[0]
    for p, got in zip(prompts, outs[1]):
        assert got == _oracle(jmodel, jparams, p, 6)


def test_llmservice_greedy_matches_jax_service(global_f32):
    jcfg, tcfg, jmodel, jparams, tparams = global_f32
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n).tolist() for n in (10, 4, 17)]
    params = dict(max_new_tokens=5, stop_token_ids=())
    want = JaxService(JaxEngine(jcfg, jparams, JaxEngineConfig(
        **_ecfg()))).generate(prompts, JaxParams(**params))
    svc = LLMService(PagedEngine(tcfg, tparams, EngineConfig(
        **_ecfg(enable_telemetry=True)), device="cpu"))
    got = svc.generate(prompts, SamplingParams(**params))
    # telemetry on: per-iteration metric rows and engine trace spans
    rows = svc.metrics_timelines()[0]
    assert rows[-1]["tokens"] == 31 + 3 * 4  # prompts + decoded tokens
    assert any(e.name == "chunk" for e in svc.trace_events())
    for g, w, p in zip(got, want, prompts):
        assert g.token_ids == w.token_ids == _oracle(jmodel, jparams, p, 5)
        assert g.finish_reason == w.finish_reason == "length"
        np.testing.assert_allclose(g.cumulative_logprob,
                                   w.cumulative_logprob, rtol=1e-4)
    assert svc.stats().n_requests == 3 and not svc.pending


def test_llmservice_sampled_stream_is_batch_independent(global_f32):
    """A sampled request draws the same tokens alone and inside a mixed
    greedy / sampled batch (its stream is keyed by its own seed and token
    index), and its tokens are finite-probability tokens of the kept set."""
    _, tcfg, jmodel, jparams, tparams = global_f32
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 512, 12).tolist()
    sp = SamplingParams(temperature=0.8, top_k=20, top_p=0.9,
                        max_new_tokens=6, seed=123)

    def serve(prompts_params):
        svc = LLMService(PagedEngine(tcfg, tparams, EngineConfig(**_ecfg()),
                                     device="cpu"))
        ids = [svc.submit(p, s) for p, s in prompts_params]
        svc.drain()
        return [svc._take_result(i) for i in ids]

    alone = serve([(prompt, sp)])[0]
    others = [rng.integers(0, 512, n).tolist() for n in (5, 20)]
    mixed = serve([(others[0], SamplingParams(max_new_tokens=7)),
                   (prompt, sp),
                   (others[1], SamplingParams(temperature=1.0, seed=7,
                                              max_new_tokens=4))])
    assert mixed[1].token_ids == alone.token_ids
    assert mixed[0].token_ids == _oracle(jmodel, jparams, others[0], 7)
    assert all(np.isfinite(s.cumulative_logprob) for s in alone.samples)
    assert len(alone.token_ids) == 6
