"""The port's engine statistics and scalar sampler against the JAX
package's, on the CPU.

``PagedEngine.kv_utilization()`` and ``prefix_cache_stats()``: the port's
engine and the JAX engine run the same requests in lock step on the same
float32 weights (carried over by the bridge), and after every ``step()``
both numbers are equal (``==``), the stats as whole dicts. ``sample``:
greedy tokens equal the JAX ``sample``'s on the same logits; drawn tokens
lie in the JAX top-k set (ties at the k-th value kept and drawn); at
temperature 0.7 the frequencies of 40,000 draws stay within five binomial
standard deviations (plus 1e-4) of ``softmax(logits / T)``. The port draws
with a ``torch.Generator``, not threefry: the distribution is the
reference's, the bits are not.
"""

import dataclasses
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.scheduling.request import Request as JaxRequest
from repro.models import Model as JaxModel
from repro.models.sampling import sample as jax_sample
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedEngine as JaxEngine

from repro_torch.bridge import from_numpy_tree
from repro_torch.configs import ArchConfig
from repro_torch.core.scheduling.request import Request
from repro_torch.models.sampling import sample
from repro_torch.serving.engine import EngineConfig, PagedEngine

PS = 8
LIMIT_S = 240  # each test's own time limit
N_DRAWS = 40_000
FREQ_SIGMAS = 5.0  # the frequency bound, in binomial standard deviations


@pytest.fixture(autouse=True)
def time_limit():
    """A test that runs past LIMIT_S seconds fails instead of hanging."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past {LIMIT_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def setup():
    """Smoke danube without its window (as ``tests/test_engine.py`` and
    ``tests/test_prefix_cache.py`` serve it), float32, JAX weights."""
    jcfg = dataclasses.replace(jax_smoke_config("h2o-danube-1.8b"),
                               dtype="float32", logits_fp32=True,
                               sliding_window=None)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(0))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams))
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg)), jparams, tparams


def _engines(setup, **kw):
    jcfg, tcfg, jparams, tparams = setup
    kw = dict(dict(num_pages=64, page_size=PS, max_slots=4), **kw)
    return (JaxEngine(jcfg, jparams, JaxEngineConfig(**kw)),
            PagedEngine(tcfg, tparams, EngineConfig(**kw), device="cpu"))


def _lock_step(je, te, arrivals, check):
    """Step both engines together; ``arrivals[i]`` (prompt, max_new) pairs
    join before step i. ``check(je, te)`` after every step; both must
    generate the same tokens."""
    jreqs, treqs = [], []
    i = 0
    while i < len(arrivals) or je.has_work or te.has_work:
        for prompt, new in (arrivals[i] if i < len(arrivals) else ()):
            rid = len(jreqs)
            jreqs.append(JaxRequest(rid, 0.0, list(prompt),
                                    max_new_tokens=new))
            treqs.append(Request(rid, 0.0, list(prompt), max_new_tokens=new))
            je.add_request(jreqs[-1])
            te.add_request(treqs[-1])
        je.step()
        te.step()
        check(je, te)
        i += 1
        assert i < 500, "the engines did not drain"
    assert [r.full_output for r in treqs] == [r.full_output for r in jreqs]
    return jreqs, treqs


def _equal_utilization(je, te):
    assert te.kv_utilization() == je.kv_utilization()


@pytest.mark.parametrize("arrivals,first_low", [
    # tests/test_engine.py:186-193: 9 tokens in 2 pages of 8, 3 new; its
    # bound on the first step's utilization
    ([[([1] * 9, 3)]], 0.5),
    # late joiners over page boundaries, chunked under a small budget
    ([[([1, 2, 3], 6)], [([4, 5], 2)], [], [(list(range(7, 27)), 9)],
      [([9] * 16, 5), ([3] * 8, 1)]], 0.0),
], ids=["test_engine_scenario", "late_joiners"])
def test_kv_utilization_equals_jax_after_every_step(setup, arrivals,
                                                    first_low):
    je, te = _engines(setup, max_tokens_per_iter=16)
    seen = []
    _lock_step(je, te, arrivals, lambda a, b: (
        _equal_utilization(a, b), seen.append(b.kv_utilization())))
    assert first_low <= seen[0] <= 1.0 and seen[0] > 0
    assert te.kv_utilization() == 1.0  # drained: nothing allocated


def _shared_prompts(vocab):
    """tests/test_prefix_cache.py's 8 sessions over a 2-page system
    prompt."""
    rng = np.random.default_rng(5)
    system = rng.integers(0, vocab, 2 * PS).tolist()
    return [system + rng.integers(0, vocab, 6).tolist() for _ in range(8)]


def test_prefix_cache_stats_equal_jax_after_every_step(setup):
    """One session at a time, as the reference test drives them: after
    every step the port's stats dict equals the JAX engine's; every
    follow-up session reuses the system prompt's 16 tokens."""
    je, te = _engines(setup, enable_prefix_cache=True)
    prompts = _shared_prompts(setup[0].vocab_size)
    treqs = []
    for p in prompts:
        treqs += _lock_step(je, te, [[(p, 4)]], lambda a, b: (
            _equal_utilization(a, b),
            _assert_same_stats(a.prefix_cache_stats(),
                               b.prefix_cache_stats())))[1]
    assert [r.num_cached_tokens for r in treqs] == [0] + [2 * PS] * 7
    stats = te.prefix_cache_stats()
    assert stats["hit_rate"] >= 0.5
    assert stats["hit_tokens"] == sum(r.num_cached_tokens for r in treqs)


def test_prefix_cache_stats_under_concurrent_sessions(setup):
    """The same sessions arriving two at a time into four slots: lookups
    that race an insert, equal after every step."""
    je, te = _engines(setup, enable_prefix_cache=True)
    prompts = _shared_prompts(setup[0].vocab_size)
    arrivals = [[(p, 4) for p in prompts[i:i + 2]]
                for i in range(0, len(prompts), 2)]
    _lock_step(je, te, arrivals, lambda a, b: _assert_same_stats(
        a.prefix_cache_stats(), b.prefix_cache_stats()))
    assert te.prefix_cache_stats()["hit_tokens"] > 0


def _assert_same_stats(want, got):
    assert set(got) == set(want)
    assert got == {k: (v.item() if hasattr(v, "item") else v)
                   for k, v in want.items()}


def test_engine_without_cache_reports_no_stats(setup):
    je, te = _engines(setup)
    assert te.prefix_cache_stats() == je.prefix_cache_stats() == {}
    _lock_step(je, te, [[([1, 2, 3, 4], 2)]], lambda a, b: (
        _equal_utilization(a, b),
        _assert_same_stats(a.prefix_cache_stats(), b.prefix_cache_stats())))
    assert te.prefix_cache_stats() == {}


# -- sampling.sample --------------------------------------------------------

def _logits(seed, rows=8, vocab=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, vocab)) * 3).astype(np.float32)


@pytest.mark.parametrize("temperature", [0.0, -1.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_greedy_equals_jax(temperature, seed):
    x = _logits(seed)
    x[0, 5] = x[0, 9] = x[0].max() + 1.0  # an exact tie: the first wins
    want = np.asarray(jax_sample(jnp.asarray(x), jax.random.PRNGKey(seed),
                                 temperature=temperature, top_k=3))
    got = sample(torch.from_numpy(x), torch.Generator().manual_seed(seed),
                 temperature=temperature, top_k=3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("top_k", [1, 3, 10])
def test_sample_stays_in_the_jax_top_k_set(top_k):
    """Logits on a coarse grid, and one row tied across the k-th value: the
    set is every token at or above JAX ``lax.top_k``'s k-th value (ties
    kept, as the reference's ``logits < kth`` keeps them). Over many
    generator seeds every draw lies in it, and every token of the tied row
    that the set holds is drawn."""
    rng = np.random.default_rng(top_k)
    x = np.round(rng.standard_normal((6, 40)) * 2).astype(np.float32)
    x[0] = -4.0
    x[0, :top_k + 2] = 1.0  # k + 2 tokens tie at the k-th value
    kth = np.asarray(jax.lax.top_k(jnp.asarray(x), top_k)[0])[:, -1:]
    allowed = x >= kth
    assert allowed[0].sum() == top_k + 2
    drawn = np.zeros_like(allowed)
    rows = np.arange(x.shape[0])
    for seed in range(300):
        tok = sample(torch.from_numpy(x), torch.Generator().manual_seed(seed),
                     temperature=1.5, top_k=top_k).numpy()
        assert allowed[rows, tok].all(), (seed, tok)
        drawn[rows, tok] = True
    assert (drawn[0] == allowed[0]).all()
    for seed in range(20):  # the JAX sampler's draws lie in the same set
        jtok = np.asarray(jax_sample(jnp.asarray(x), jax.random.PRNGKey(seed),
                                     temperature=1.5, top_k=top_k))
        assert allowed[rows, jtok].all()


@pytest.mark.parametrize("top_k", [0, 5])
def test_sample_frequencies_match_softmax(top_k):
    """N_DRAWS rows of one logit vector at temperature 0.7: each token's
    frequency within FREQ_SIGMAS binomial standard deviations (+1e-4) of
    the JAX ``softmax(logits / T)`` over the top-k-filtered logits."""
    t = 0.7
    x = _logits(7, rows=1, vocab=16)[0]
    z = jnp.asarray(x) / t
    if top_k:
        kth = jax.lax.top_k(z, top_k)[0][-1]
        z = jnp.where(z < kth, -jnp.inf, z)
    p = np.asarray(jax.nn.softmax(z), np.float64)
    rows = torch.from_numpy(np.tile(x, (N_DRAWS, 1)))
    tok = sample(rows, torch.Generator().manual_seed(11), temperature=t,
                 top_k=top_k).numpy()
    freq = np.bincount(tok, minlength=x.size) / N_DRAWS
    bound = FREQ_SIGMAS * np.sqrt(p * (1 - p) / N_DRAWS) + 1e-4
    assert (np.abs(freq - p) <= bound).all(), np.abs(freq - p) / bound
    assert (freq[p == 0] == 0).all()
