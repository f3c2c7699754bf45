"""Cluster serving on the port against the JAX package, on the CPU, in
float32 (``dtype="float32", logits_fp32=True``): ``RouterBackend`` over
the port's ``PagedEngine``s in the four modes that move KV between
instances (zero-copy and copy prefix sharing, migrate and zero-copy
disaggregated handoff), the engine's page payloads, and the launcher's
cluster flags.

Parity rule. Greedy tokens of each port cluster run are compared with the
port's single engine and with the JAX engine's cluster run of the same
mode on the same weights (carried over by the bridge). A zero-copy run
merges a local and a remote attention partial, which sums in another
order than one softmax does, so float32 tokens may differ at a near-tie:
a token may differ only where the port's ``Model.forward`` over the prompt
and the reference's tokens puts the two candidates on top, within 2**-7
of the largest |logit| (``chip_smoke.py``'s ``NEAR_TIE``); comparing that
request stops there. The seeds were not chosen to avoid near-ties: the
rule is applied to whatever they give, and the number of stops is
bounded.

The configs are smoke sizes without a sliding window (zero-copy refuses
windows): h2o-danube-1.8b with ``sliding_window=None`` for GQA and
deepseek-v2-236b for MLA, pages of 8 tokens.
"""

import contextlib
import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.scheduling.request import Phase as JaxPhase
from repro.core.scheduling.request import Request as JaxRequest
from repro.models import Model as JaxModel
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedEngine as JaxEngine
from repro.serving.router import RouterBackend as JaxRouter

from repro_torch.bridge import from_numpy_tree
from repro_torch.configs import ArchConfig
from repro_torch.core.scheduling.request import Phase, Request
from repro_torch.launch import serve
from repro_torch.models.transformer import Model
from repro_torch.serving.api import LLMService, SamplingParams
from repro_torch.serving.engine import EngineConfig, PagedEngine
from repro_torch.serving.router import RouterBackend

PS = 8
NEAR_TIE = 2.0 ** -7


def _setup(arch, **kw):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               logits_fp32=True, **kw)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(0))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams))
    return dict(jcfg=jcfg, jparams=jparams,
                tcfg=ArchConfig(**dataclasses.asdict(jcfg)), tparams=tparams)


@pytest.fixture(scope="module")
def gqa():
    return _setup("h2o-danube-1.8b", sliding_window=None)


@pytest.fixture(scope="module")
def mla():
    return _setup("deepseek-v2-236b")


class Scripted:
    """Placement by a fixed list of instance indices."""

    def __init__(self, script):
        self.script = list(script)

    def choose(self, req, children):
        return self.script.pop(0)


def _ekw(**kw):
    return dict(dict(num_pages=64, page_size=PS, max_slots=4), **kw)


def _engine(setup, side, **kw):
    if side == "jax":
        return JaxEngine(setup["jcfg"], setup["jparams"],
                         JaxEngineConfig(**_ekw(**kw)))
    return PagedEngine(setup["tcfg"], setup["tparams"],
                       EngineConfig(**_ekw(**kw)), device="cpu")


def _cluster(setup, side, prompts, waves, n_new, *, n=2, engine_kw=None,
             **router_kw):
    """A RouterBackend of ``side`` over ``n`` engines; ``waves`` lists the
    request indices added together, each wave drained before the next."""
    engines = [_engine(setup, side, **(engine_kw or {})) for _ in range(n)]
    router = (JaxRouter if side == "jax" else RouterBackend)(
        engines, **router_kw)
    R = JaxRequest if side == "jax" else Request
    reqs = [R(i, 0.0, list(p), max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    for wave in waves:
        for i in wave:
            router.add_request(reqs[i])
        while router.has_work:
            router.step()
    return router, engines, reqs


def _single(setup, prompts, n_new, **kw):
    """The port's single engine, each prompt alone."""
    engine = _engine(setup, "port", **kw)
    out = []
    for i, p in enumerate(prompts):
        r = Request(i, 0.0, list(p), max_new_tokens=n_new)
        engine.add_request(r)
        engine.run_to_completion()
        out.append(r.full_output)
    return out


def _assert_same_tokens(setup, prompts, got, want, what):
    """``got`` against ``want`` request by request, by the module's
    near-tie rule. Returns the number of near-tie stops."""
    model = Model(setup["tcfg"])
    vocab = setup["tcfg"].vocab_size
    stops = 0
    for prompt, a, b in zip(prompts, got, want):
        assert len(a) == len(b), (what, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            if x == y:
                continue
            logits, _ = model.forward(setup["tparams"],
                                      torch.tensor([prompt + b[:i]]))
            last = logits[0, -1, :vocab]
            top = torch.topk(last, 2)
            assert {x, y} == set(top.indices.tolist()) and \
                float(top.values[0] - top.values[1]) < \
                NEAR_TIE * float(last.abs().max()), (what, i, x, y)
            stops += 1
            break
    assert stops <= max(1, len(prompts) // 3), (what, stops)
    return stops


def _outputs(reqs):
    return [r.full_output for r in reqs]


# -- zero-copy prefix sharing ----------------------------------------------------

def _share_prompts(vocab, seed, suffix):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 2 * PS).tolist()
    return [prefix + rng.integers(0, vocab, n).tolist() for n in suffix]


@pytest.mark.parametrize("budget,suffix", [
    (2048, (4, 4, 4)),  # one suffix chunk
    (8, (3, 3, 20)),    # the borrower's 20-token suffix in three chunks
])
def test_zero_copy_share_matches_copy_single_and_jax(gqa, budget, suffix):
    """Instance 1 admits the third prompt with a lease on instance 0's two
    prefix pages: its suffix chunks and every decode step merge a local and
    a remote partial (the decode's through paged_attention's (m, l)), and
    no payload moves. Its tokens equal copy sharing's, the single
    engine's and the JAX cluster's (copy sharing's the JAX copy
    cluster's); every lease is repaid at finish."""
    prompts = _share_prompts(gqa["jcfg"].vocab_size, 12 + budget, suffix)
    kw = dict(prompts=prompts, waves=[[0], [1], [2]], n_new=4,
              engine_kw=dict(enable_prefix_cache=True,
                             max_tokens_per_iter=budget),
              prefix_share=True, hot_threshold=1)
    runs = {}
    for side in ("port", "jax"):
        for mode in ("zero_copy", "copy"):
            runs[side, mode] = _cluster(gqa, side, share_mode=mode,
                                        policy=Scripted([0, 0, 1]), **kw)
    router, engines, reqs = runs["port", "zero_copy"]
    assert reqs[2].instance_id == 1 and reqs[2].num_cached_tokens == 2 * PS
    assert router.leases_granted == 1 and router.pages_borrowed == 2
    assert engines[1].prefix_cache.adopted_pages == 0, "zero-copy copied"
    assert not router.g.ledger, "a lease outlived its request"
    b = engines[1]
    assert b.leased_chunks == (1 if budget > 20 else 3)
    assert b.leased_decode_steps == b.remote_partials == 3
    assert engines[0].leased_decode_steps == 0
    assert runs["port", "copy"][1][1].prefix_cache.adopted_pages == 2
    assert runs["jax", "zero_copy"][0].pages_borrowed == 2
    got = _outputs(reqs)
    _assert_same_tokens(gqa, prompts, got, _outputs(runs["port", "copy"][2]),
                        "copy share")
    _assert_same_tokens(gqa, prompts, got,
                        _single(gqa, prompts, 4, max_tokens_per_iter=budget),
                        "single engine")
    _assert_same_tokens(gqa, prompts, got,
                        _outputs(runs["jax", "zero_copy"][2]), "JAX cluster")
    _assert_same_tokens(gqa, prompts, _outputs(runs["port", "copy"][2]),
                        _outputs(runs["jax", "copy"][2]), "JAX copy share")


def test_zero_copy_share_mla_matches_copy_single_and_jax(mla):
    """The MLA flavour: the borrower reads the creditor's latent ckv /
    krope pages, the chunk and the decode through the plain float32
    partials of the reference's latent form."""
    prompts = _share_prompts(mla["jcfg"].vocab_size, 5, (5, 5, 9))
    kw = dict(prompts=prompts, waves=[[0], [1], [2]], n_new=4,
              engine_kw=dict(enable_prefix_cache=True),
              prefix_share=True, hot_threshold=1)
    runs = {(side, mode): _cluster(mla, side, share_mode=mode,
                                   policy=Scripted([0, 0, 1]), **kw)
            for side, mode in (("port", "zero_copy"), ("port", "copy"),
                               ("jax", "zero_copy"))}
    router, engines, reqs = runs["port", "zero_copy"]
    assert engines[1].kv_layout.flavor == "mla"
    assert router.pages_borrowed == 2 and not router.g.ledger
    assert engines[1].prefix_cache.adopted_pages == 0
    assert engines[1].leased_chunks == 1
    assert engines[1].leased_decode_steps == 3
    assert runs["port", "copy"][1][1].prefix_cache.adopted_pages == 2
    got = _outputs(reqs)
    for what, want in (("copy share", _outputs(runs["port", "copy"][2])),
                       ("single engine", _single(mla, prompts, 4)),
                       ("JAX cluster", _outputs(runs["jax", "zero_copy"][2]))):
        _assert_same_tokens(mla, prompts, got, want, what)


def test_zero_copy_decode_merges_two_creditors(gqa):
    """Three instances: prefix P is hot on instance 0, prefix Q on
    instance 1, and instance 2 admits one request of each at once. Its
    decode batch holds leases from two homes: one remote partial per
    creditor per layer, each row with context 0 in the other creditor's
    partial."""
    vocab = gqa["jcfg"].vocab_size
    rng = np.random.default_rng(41)
    p, q = (rng.integers(0, vocab, 2 * PS).tolist() for _ in range(2))
    prompts = [p + rng.integers(0, vocab, 3).tolist() for _ in range(2)] + \
        [q + rng.integers(0, vocab, 3).tolist() for _ in range(2)] + \
        [p + rng.integers(0, vocab, 5).tolist(),
         q + rng.integers(0, vocab, 6).tolist()]
    kw = dict(prompts=prompts, waves=[[0], [1], [2], [3], [4, 5]], n_new=5,
              n=3, engine_kw=dict(enable_prefix_cache=True),
              prefix_share=True, share_mode="zero_copy", hot_threshold=1)
    router, engines, reqs = _cluster(gqa, "port",
                                     policy=Scripted([0, 0, 1, 1, 2, 2]),
                                     **kw)
    jrouter, _, jreqs = _cluster(gqa, "jax",
                                 policy=Scripted([0, 0, 1, 1, 2, 2]), **kw)
    c = engines[2]
    assert router.leases_granted == jrouter.leases_granted == 2
    assert c.remote_partials > c.leased_decode_steps > 0
    assert not router.g.ledger
    got = _outputs(reqs)
    _assert_same_tokens(gqa, prompts, got, _outputs(jreqs), "JAX cluster")
    _assert_same_tokens(gqa, prompts, got, _single(gqa, prompts, 5),
                        "single engine")


# -- disaggregated prefill/decode handoff -----------------------------------------

@pytest.mark.parametrize("mode", ["migrate", "zero_copy"])
def test_handoff_matches_single_and_jax(gqa, mode):
    """Prompt KV prefilled on instance 0 and decoded on instance 1, for a
    prompt that fills its last page exactly and one with a partial tail.
    A zero-copy handoff leases every full prompt page and copies only the
    tail; the exact prompt has no local page until its first decode write,
    which lands at local position 0 of a fresh page."""
    rng = np.random.default_rng(33)
    prompts = [rng.integers(0, gqa["jcfg"].vocab_size, n).tolist()
               for n in (2 * PS, 2 * PS + 4)]
    kw = dict(prompts=prompts, waves=[[0], [1]], n_new=4,
              roles=["prefill", "decode"], handoff_mode=mode)
    router, engines, reqs = _cluster(gqa, "port", **kw)
    jrouter, _, jreqs = _cluster(gqa, "jax", **kw)
    ho = router.handoff
    if mode == "migrate":
        assert (ho.handoffs_migrated, ho.handoffs_leased) == (2, 0)
        assert engines[1].allocator.num_free == 64, "D kept a page"
    else:
        assert (ho.handoffs_leased, ho.pages_leased, ho.pages_copied) == \
            (2, 4, 1)
        assert engines[1].leased_decode_steps > 0
    assert (ho.handoffs_migrated, ho.handoffs_leased) == \
        (jrouter.handoff.handoffs_migrated, jrouter.handoff.handoffs_leased)
    assert not router.g.ledger, "a handoff lease outlived its request"
    for r, jr in zip(reqs, jreqs):
        assert r.phase == Phase.FINISHED and jr.phase == JaxPhase.FINISHED
        assert r.instance_id == jr.instance_id == 1
    got = _outputs(reqs)
    _assert_same_tokens(gqa, prompts, got, _outputs(jreqs), "JAX cluster")
    _assert_same_tokens(gqa, prompts, got, _single(gqa, prompts, 4),
                        "single engine")


def test_zero_copy_handoff_writes_at_local_position_zero(gqa):
    """The first decode of a handed-off prompt that fills its last page:
    position prompt_len, r_base prompt_len, so the write lands at local
    position 0 of the one local page the scheduler added, and the local
    context is that one token."""
    prompt = np.random.default_rng(3).integers(
        0, gqa["jcfg"].vocab_size, 3 * PS).tolist()
    engines = [_engine(gqa, "port") for _ in range(2)]
    router = RouterBackend(engines, roles="1p1d", handoff_mode="zero_copy")
    seen = []
    decode = engines[1]._decode

    def recording(toks, pos, bt, lens, r_base=None, remote=()):
        seen.append((pos.copy(), bt.copy(), lens.copy(),
                     None if r_base is None else r_base.copy(), remote))
        return decode(toks, pos, bt, lens, r_base, remote)

    engines[1]._decode = recording
    req = Request(0, 0.0, prompt, max_new_tokens=3)
    router.add_request(req)
    while router.has_work:
        router.step()
    pos, bt, lens, r_base, remote = seen[0]
    slot = int(np.flatnonzero(lens)[0])
    assert pos[slot] == r_base[slot] == 3 * PS and lens[slot] == 3 * PS + 1
    assert pos[slot] - r_base[slot] == 0 and bt.shape[1] == 1
    ((home, rbt, rlens),) = remote
    assert home == 0 and rlens[slot] == 3 * PS
    assert rbt.shape[1] == 3
    assert len(seen) == 2 and not router.g.ledger
    assert req.full_output == _single(gqa, [prompt], 3)[0]


# -- page payloads ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "deepseek-v2-236b"])
def test_page_payload_round_trip_is_bit_exact(arch):
    """A bf16 engine's page comes out as CPU tensors in the pool's dtype
    and shape and lands bit for bit in another engine's block; the source
    page is untouched."""
    from repro_torch.bridge import init_params
    from repro_torch.configs import smoke_config
    cfg = smoke_config(arch)
    params = init_params(cfg, seed=0, device="cpu")
    a, b = (PagedEngine(cfg, params, EngineConfig(**_ekw()), device="cpu")
            for _ in range(2))
    gen = torch.Generator().manual_seed(1)
    for pool in (a.k_pages, a.v_pages):
        pool.copy_(torch.randn(pool.shape, generator=gen))
    schema, pa, pb = a.export_page_payload(3)
    assert schema == a.kv_layout.schema and pa.device.type == "cpu"
    assert pa.dtype == a.k_pages.dtype == torch.bfloat16
    assert pa.shape == (cfg.num_layers,) + a.k_pages.shape[2:]
    before = (a.k_pages.clone(), a.v_pages.clone())
    pa.zero_()  # the payload owns its memory
    assert torch.equal(a.k_pages, before[0])
    payloads = [a.export_page_payload(i) for i in (3, 7)]
    b.import_page_payloads([5, 9], payloads)
    for src, dst in ((3, 5), (7, 9)):
        for pa_, pb_ in ((a.k_pages, b.k_pages), (a.v_pages, b.v_pages)):
            assert torch.equal(pa_[:, src].view(torch.int16),
                               pb_[:, dst].view(torch.int16))
    assert torch.equal(a.v_pages, before[1])


def test_page_payload_import_refuses_before_any_write(gqa):
    """A foreign schema, dtype or page shape anywhere in the batch raises
    before any pool is written."""
    b = _engine(gqa, "port")
    gen = torch.Generator().manual_seed(2)
    for pool in (b.k_pages, b.v_pages):
        pool.copy_(torch.randn(pool.shape, generator=gen))
    good = b.export_page_payload(0)
    schema, pa, pb = good
    bad = [("gqa:k9x9+v9x9:f32", pa, pb), (schema, pa.double(), pb),
           (schema, pa, pb[:, :-1]), (schema, pa.numpy(), pb)]
    for i, payload in enumerate(bad):
        before = (b.k_pages.clone(), b.v_pages.clone())
        with pytest.raises(ValueError):
            b.import_page_payloads([1, 2], [good, payload])
        assert torch.equal(b.k_pages, before[0])
        assert torch.equal(b.v_pages, before[1]), i
    with pytest.raises(ValueError, match="blocks"):
        b.import_page_payloads([1, 2], [good])


def test_page_payload_equals_jax_export(gqa):
    """The same request on the JAX engine and the port's: each prompt
    page's payload, converted to float32, equals the JAX engine's export
    of the same page. Layer 0's K/V agree to 1e-5; deeper layers inherit
    the bf16 rounding flips of the prefill attention, as the engine tests
    hold them (1e-2 worst, 1e-5 median)."""
    prompt = np.random.default_rng(7).integers(
        0, gqa["jcfg"].vocab_size, 3 * PS + 2).tolist()
    engines = []
    for side, R in (("jax", JaxRequest), ("port", Request)):
        e = _engine(gqa, side)
        e.add_request(R(0, 0.0, list(prompt), max_new_tokens=4))
        e.step()
        e.step()  # the prompt's pages and one decode write
        engines.append(e)
    je, te = engines
    blocks = te.scheduler.tables[0].blocks
    assert blocks == je.scheduler.tables[0].blocks and len(blocks) == 4
    for blk in blocks:
        js, ja, jb = je.export_page_payload(blk)
        ts, ta, tb = te.export_page_payload(blk)
        assert ts == js
        for x, y in ((ta, ja), (tb, jb)):
            x, y = x.float().numpy(), np.asarray(y, np.float32)
            assert x.shape == y.shape
            np.testing.assert_allclose(x[0], y[0], rtol=1e-5, atol=1e-5)
            d = np.abs(x - y)
            assert d.max() <= 1e-2 and np.median(d) <= 1e-5
    assert np.abs(te.export_page_payload(blocks[-1])[1].numpy()).max() > 0


# -- lease lifetime on in-place pools ------------------------------------------------

def test_leased_pages_stay_bit_identical(gqa):
    """A borrower holds a lease on two of the creditor's pages while the
    creditor keeps decoding, admits new requests (one sharing the prefix,
    one best-of-2 whose sibling COW-copies its partial page) on a pool too
    small for all of them, and finishes them. The leased pages stay bit
    for bit as they were, the borrower's tokens equal the single
    engine's, and every lease is repaid."""
    vocab = gqa["jcfg"].vocab_size
    rng = np.random.default_rng(17)
    prefix = rng.integers(0, vocab, 2 * PS).tolist()
    prompts = [prefix + rng.integers(0, vocab, 3).tolist() for _ in range(3)]
    engines = [_engine(gqa, "port", num_pages=12, enable_prefix_cache=True)
               for _ in range(2)]
    router = RouterBackend(engines, policy=Scripted([0, 0, 1, 0, 0, 0, 0]),
                           prefix_share=True, share_mode="zero_copy",
                           hot_threshold=1)
    svc = LLMService(router)
    for p in prompts[:2]:
        svc.submit(p, SamplingParams(max_new_tokens=3))
        while svc.pending:
            svc.poll()
    borrower = svc.submit(prompts[2], SamplingParams(max_new_tokens=12))
    svc.poll()
    lease = engines[1].scheduler.leases[borrower]
    creditor = engines[0]
    idx = torch.as_tensor(lease.blocks)
    leased = (creditor.k_pages[:, idx].clone(),
              creditor.v_pages[:, idx].clone())
    for plen, new, n in ((25, 10, 1), (21, 8, 1), (13, 6, 2), (30, 6, 1)):
        toks = (prefix + rng.integers(0, vocab, plen - 2 * PS).tolist()
                if plen == 25 else rng.integers(0, vocab, plen).tolist())
        svc.submit(toks, SamplingParams(max_new_tokens=new, n=n))
    steps = 0
    while svc.pending:
        svc.poll()
        steps += 1
        assert torch.equal(creditor.k_pages[:, idx], leased[0])
        assert torch.equal(creditor.v_pages[:, idx], leased[1])
    assert steps >= 10 and creditor.decode_steps > 10
    assert creditor.prefix_cache.evicted_pages + creditor.preemptions > 0
    assert not router.g.ledger
    out = svc._take_result(borrower).token_ids
    _assert_same_tokens(gqa, prompts[2:], [out],
                        _single(gqa, prompts[2:], 12), "single engine")


# -- the launcher --------------------------------------------------------------------

@pytest.mark.parametrize("flags,expect", [
    (["--instances", "2", "--prefix-cache", "--prefix-share",
      "--share-mode", "zero_copy"], "instance 1:"),
    (["--roles", "1p1d", "--handoff-mode", "zero_copy"],
     "0 migrated + 6 leased KV handoffs"),
    (["--roles", "1p1d", "--handoff-mode", "migrate"],
     "6 migrated + 0 leased KV handoffs"),
])
def test_launcher_serves_a_cluster_on_cpu(flags, expect):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stats = serve.main(["--arch", "paper-opt-13b", "--reduced",
                            "--device", "cpu", "--requests", "6",
                            "--rate", "50", "--pages", "64", "--page-size",
                            "8", "--slots", "4", *flags])
    assert stats.n_finished == stats.n_requests == 6
    assert expect in out.getvalue(), out.getvalue()


def test_launcher_refuses_bad_cluster_flags():
    for flags in (["--prefix-share", "--instances", "2"],
                  ["--prefix-cache", "--prefix-share"],
                  ["--share-mode", "zero_copy"],
                  ["--roles", "2x"], ["--roles", "1p1d", "--instances", "3"],
                  ["--roles", "2p"]):
        with pytest.raises(SystemExit):
            serve.main(["--reduced", "--device", "cpu", "--requests", "1",
                        *flags])
