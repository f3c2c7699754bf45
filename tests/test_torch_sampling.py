"""Sampling: the port's ``filter_logits`` / greedy / logprobs against the JAX
reference, and the properties of its own counter-based sampled stream.

The reference samples with JAX's threefry bits, which the port does not
reproduce, so sampled rows are checked for what they must guarantee: the
token lies in the top-k/top-p kept set, and a row's draw is a function of
its (seed, step) alone. Tolerances: float32, 1e-5 (sum order only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import sampling as jsampling

from repro_torch.models import sampling as tsampling


def _rows(n=6, v=300, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((n, v)) * 3).astype(np.float32)
    top_k = np.array([0, 1, 5, 0, 40, 7][:n], np.int32)
    top_p = np.array([1.0, 1.0, 1.0, 0.3, 0.9, 0.5][:n], np.float32)
    return logits, top_k, top_p


def test_filter_logits_matches_reference():
    logits, top_k, top_p = _rows()
    got = tsampling.filter_logits(torch.from_numpy(logits),
                                  torch.from_numpy(top_k),
                                  torch.from_numpy(top_p))
    want = np.asarray(jsampling.filter_logits(
        jnp.asarray(logits), jnp.asarray(top_k), jnp.asarray(top_p)))
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    kept = ~np.isinf(want)
    np.testing.assert_allclose(got.numpy()[kept], want[kept], rtol=1e-6)


def test_greedy_rows_and_logprobs_match_reference():
    logits, top_k, top_p = _rows(seed=1)
    n = logits.shape[0]
    temp = np.array([0.0, 0.0, 0.7, 0.0, 1.3, 0.0], np.float32)
    seeds = np.arange(n, dtype=np.int32) * 11
    steps = np.arange(n, dtype=np.int32)
    tt, tl = tsampling.sample_batch(
        *(torch.from_numpy(a) for a in (logits, seeds, steps, temp, top_k,
                                        top_p)))
    jt, jl = jsampling.sample_batch(
        *(jnp.asarray(a) for a in (logits, seeds, steps, temp, top_k,
                                   top_p)))
    greedy = temp <= 0
    np.testing.assert_array_equal(tt.numpy()[greedy], np.asarray(jt)[greedy])
    np.testing.assert_array_equal(
        tsampling.greedy(torch.from_numpy(logits)).numpy(),
        np.asarray(jsampling.greedy(jnp.asarray(logits))))
    # logprobs under the raw logits, for whichever token each row drew
    lsm = np.asarray(jnp.asarray(logits) - jnp.asarray(
        np.log(np.exp(logits.astype(np.float64)).sum(-1, keepdims=True)),
        jnp.float32))
    np.testing.assert_allclose(
        tl.numpy(), lsm[np.arange(n), tt.numpy()], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.numpy()[greedy], np.asarray(jl)[greedy],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampled_tokens_stay_in_kept_set(seed):
    logits, top_k, top_p = _rows(seed=seed)
    n = logits.shape[0]
    temp = np.full(n, 0.8, np.float32)
    kept = np.isfinite(np.asarray(jsampling.filter_logits(
        jnp.asarray(logits / 0.8), jnp.asarray(top_k), jnp.asarray(top_p))))
    for step in range(20):
        toks, _ = tsampling.sample_batch(
            torch.from_numpy(logits), torch.full((n,), seed),
            torch.full((n,), step), torch.from_numpy(temp),
            torch.from_numpy(top_k), torch.from_numpy(top_p))
        assert kept[np.arange(n), toks.numpy()].all()
        assert (toks[1] == int(logits[1].argmax())).item()  # top_k = 1


def test_stream_is_a_function_of_seed_and_step():
    """The same (seed, step) draws the same token whatever row, batch or
    neighbours it has; another step or seed draws independently."""
    logits = torch.zeros(1, 1000)  # uniform: the draw is all noise
    one = lambda s, t: int(tsampling.sample_batch(
        logits, torch.tensor([s]), torch.tensor([t]), torch.tensor([1.0]),
        torch.tensor([0]), torch.tensor([1.0]))[0][0])
    batch = tsampling.sample_batch(
        logits.expand(4, 1000), torch.tensor([9, 5, 5, 7]),
        torch.tensor([3, 3, 4, 0]), torch.ones(4), torch.zeros(4,
                                                               dtype=int),
        torch.ones(4))[0].tolist()
    assert batch == [one(9, 3), one(5, 3), one(5, 4), one(7, 0)]
    draws = [one(5, t) for t in range(200)]
    assert len(set(draws)) > 150  # not stuck: ~180 distinct of 1000
    u = tsampling.uniform_noise(torch.arange(64), torch.zeros(64,
                                                              dtype=int),
                                4096)
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
