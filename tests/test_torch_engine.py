"""The port's ``PagedEngine`` against the JAX ``PagedEngine`` and the JAX
``Model`` oracle (prefill + ring-cache decode), on the CPU, in float32.

Both engines run the same request schedule on the same weights (carried
over by the bridge); greedy tokens must be identical, to each other and to
the oracle. KV pages are compared at a stated tolerance, not bit for bit:
layer 0's K/V agree to 1e-5; deeper layers inherit the bfloat16 rounding
flips of the prefill attention (q, k, v and probabilities are rounded to
bf16 in both packages, and a one-ulp float32 difference can flip a
rounding, 2**-8 relative), so they are held at 1e-2 in the worst element
and 1e-5 in the median. The trash page is left out: the JAX engine parks
NaN there (its oracle's empty rows), the port zeros.
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

PS = 8


def _setup(window):
    jcfg = dataclasses.replace(jax_smoke_config("h2o-danube-1.8b"),
                               dtype="float32", logits_fp32=True,
                               sliding_window=window)
    jmodel = JaxModel(jcfg, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams))
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg)), jmodel, jparams, \
        tparams


@pytest.fixture(scope="module")
def global_f32():
    return _setup(None)


def _oracle(jmodel, jparams, prompt, n):
    """Greedy tokens from the JAX Model: prefill, then ring-cache decode."""
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


def _engines(setup, **kw):
    jcfg, tcfg, _, jparams, tparams = setup
    kw.setdefault("num_pages", 64)
    kw.setdefault("page_size", PS)
    kw.setdefault("max_slots", 4)
    je = JaxEngine(jcfg, jparams, JaxEngineConfig(**kw))
    te = PagedEngine(tcfg, tparams, EngineConfig(**kw), device="cpu")
    return je, te


def _assert_pools_close(je, te):
    P = je.ecfg.num_pages  # the trash page (index P) is left out
    for jp, tp in ((je.k_pages, te.k_pages), (je.v_pages, te.v_pages)):
        a = np.asarray(jp)[:, :P]
        b = tp[:, :P].numpy()
        np.testing.assert_allclose(b[0], a[0], rtol=1e-5, atol=1e-5)
        d = np.abs(a - b)
        assert d.max() <= 1e-2 and np.median(d) <= 1e-5, \
            (d.max(), np.median(d))


def _cow_log(engine):
    """Record the copy-on-write pairs the scheduler hands the engine."""
    log = []
    schedule = engine.scheduler.schedule

    def recording():
        plan = schedule()
        log.extend(plan.cow)
        return plan

    engine.scheduler.schedule = recording
    return log


def test_concurrent_late_join_chunked_prefill(global_f32):
    """Four requests, two joining while the first two run; a 16-token
    budget chunks the 30- and 21-token prompts across iterations."""
    _, _, jmodel, jparams, _ = global_f32
    je, te = _engines(global_f32, max_tokens_per_iter=16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).tolist() for n in (30, 5, 21, 3)]
    max_new = [6, 4, 5, 7]
    jr = [JaxRequest(i, 0.0, list(p), max_new_tokens=m)
          for i, (p, m) in enumerate(zip(prompts, max_new))]
    tr = [Request(i, 0.0, list(p), max_new_tokens=m)
          for i, (p, m) in enumerate(zip(prompts, max_new))]
    for eng, reqs in ((je, jr), (te, tr)):
        eng.add_request(reqs[0])
        eng.add_request(reqs[1])
        eng.step()
        assert reqs[0].prefilled_len == 16  # the first chunk only
        eng.add_request(reqs[2])
        eng.step()
        eng.step()
        assert reqs[1].output  # decoding when the last request joins
        eng.add_request(reqs[3])
        eng.run_to_completion()
    assert te.iterations == je.iterations
    for a, b in zip(jr, tr):
        assert b.full_output == a.full_output, b.request_id
        assert b.full_output == _oracle(jmodel, jparams, b.prompt,
                                        len(b.full_output))
        np.testing.assert_allclose(b.logprobs, a.logprobs, rtol=1e-4,
                                   atol=1e-4)
    _assert_pools_close(je, te)


def test_mid_page_prefix_cache_hit(global_f32):
    """Two prompts diverging mid-page: the second resumes prefill at an
    unaligned boundary from a copy-on-write page, and decodes as a cold
    engine (and the oracle) does."""
    _, _, jmodel, jparams, _ = global_f32
    je, te = _engines(global_f32, enable_prefix_cache=True)
    cows = _cow_log(te)
    rng = np.random.default_rng(13)
    common = rng.integers(0, 512, 20).tolist()  # 2.5 pages
    sufa = rng.integers(0, 512, 6).tolist()
    sufb = rng.integers(0, 512, 9).tolist()
    outs = []
    for eng, R in ((je, JaxRequest), (te, Request)):
        ra = R(0, 0.0, common + sufa, max_new_tokens=2)
        eng.add_request(ra)
        eng.run_to_completion()
        rb = R(1, 0.0, common + sufb, max_new_tokens=4)
        eng.add_request(rb)
        eng.run_to_completion()
        assert rb.num_cached_tokens == 20  # 2 pages + 4 mid-page tokens
        outs.append((ra.full_output, rb.full_output))
    assert outs[1] == outs[0]
    assert cows, "the boundary page must be copied on write"
    assert outs[1][1] == _oracle(jmodel, jparams, common + sufb, 4)
    _assert_pools_close(je, te)


def test_best_of_n_cow_fork_through_llmservice(global_f32):
    """Greedy best-of-2 through LLMService: the sibling is COW-forked off
    the parent's prefill, both samples equal the oracle, and the fork is
    fully unwound."""
    _, _, jmodel, jparams, _ = global_f32
    je, te = _engines(global_f32)
    cows = _cow_log(te)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, n).tolist() for n in (11, 6)]
    want = JaxService(je).generate(prompts, JaxParams(max_new_tokens=5, n=2))
    got = LLMService(te).generate(prompts, SamplingParams(max_new_tokens=5,
                                                          n=2))
    for g, w, p in zip(got, want, prompts):
        assert len(g.samples) == 2
        assert [s.token_ids for s in g.samples] == \
            [s.token_ids for s in w.samples]
        oracle = _oracle(jmodel, jparams, p, 5)
        assert all(s.token_ids == oracle for s in g.samples)
        assert g.finish_reason == "length" and g.metrics.ttft is not None
    assert cows, "the shared partial page must be copied on write"
    assert te.allocator.num_free == te.allocator.num_blocks
    assert not te.allocator.refcount
    _assert_pools_close(je, te)
