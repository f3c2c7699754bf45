"""The port's distkv ledgers, role specs and router validation against the
JAX package's: ``GManager`` (debt ledger, creditor recommendation),
``RManager`` (rBlock lending, zero-copy leases, debtor borrowing),
``PrefixShareBoard`` (publication, pins, LRU eviction, lease hit counts),
``parse_role_spec`` and ``RouterBackend``'s refusals. These modules are
copies with their imports changed, so the same sequence of operations,
drawn with numpy from a seed, must leave the reference's objects and the
port's in equal states and give equal answers, errors included. No model
runs here."""

import dataclasses

import numpy as np
import pytest

from repro.core.distkv.gmanager import GManager as JaxGManager
from repro.core.distkv.gmanager import Heartbeat as JaxHeartbeat
from repro.core.distkv.prefixshare import PrefixShareBoard as JaxBoard
from repro.core.distkv.rmanager import RManager as JaxRManager
from repro.core.paging.allocator import BlockAllocator as JaxAllocator
from repro.core.paging.allocator import OutOfBlocks as JaxOutOfBlocks
from repro.serving.disagg import InstanceSpec as JaxInstanceSpec
from repro.serving.disagg import parse_role_spec as jax_parse_role_spec

from repro_torch.bridge import init_params
from repro_torch.configs import smoke_config
from repro_torch.core.distkv import (GManager, Heartbeat, PrefixShareBoard,
                                    RManager)
from repro_torch.core.paging.allocator import BlockAllocator, OutOfBlocks
from repro_torch.serving.disagg import InstanceSpec, parse_role_spec
from repro_torch.serving.engine import EngineConfig, PagedEngine
from repro_torch.serving.router import RouterBackend

SEEDS = range(6)


def _outcome(fn, *args):
    """``fn(*args)``'s result, or the name of the error it raised."""
    try:
        return ("ok", fn(*args))
    except (KeyError, ValueError) as e:
        return ("raised", type(e).__name__)


def _ledger(g):
    return [(e.creditor, e.debtor, e.blocks) for e in g.ledger], \
        dict(g.free), dict(g.total)


# -- GManager ----------------------------------------------------------------------

def _gmanager_ops(g, heartbeat, seed):
    rng = np.random.default_rng(seed)
    n = g.num_instances
    out = []
    for _ in range(200):
        op = rng.integers(0, 6)
        a, b = (int(x) for x in rng.integers(0, n, 2))
        k = int(rng.integers(1, 5))
        if op == 0:
            g.heartbeat(heartbeat(a, int(rng.integers(0, 12)), 16))
        elif op == 1:
            g.record_loan(a, b, k)
        elif op == 2:
            out.append(_outcome(g.record_repayment, a, b, k))
        elif op == 3:
            out.append(g.recommend_creditors(a, k, k=int(rng.integers(1, 4))))
        elif op == 4:
            out.append((g.lent_by(a), g.borrowed_by(b)))
        else:
            out.append(g.snapshot())
    return out, _ledger(g)


@pytest.mark.parametrize("seed", SEEDS)
def test_gmanager_ledger_matches_jax(seed):
    """Heartbeats, loans, repayments (some of debts that do not exist),
    creditor recommendations over a ring of 5 and the Fig. 8 snapshot."""
    assert _gmanager_ops(GManager(5, safety_free=2), Heartbeat, seed) == \
        _gmanager_ops(JaxGManager(5, safety_free=2), JaxHeartbeat, seed)


# -- RManager ----------------------------------------------------------------------

def _cluster(g_cls, rm_cls, alloc_cls, n=3, blocks=10, bs=4):
    g = g_cls(n, safety_free=2)
    rms = {i: rm_cls(i, alloc_cls(blocks, bs), g) for i in range(n)}
    for r in rms.values():
        r.register_peers(rms)
    return g, rms


def _rmanager_state(g, rms):
    allocs = {i: [r.allocator.refcount_of(b)
                  for b in range(r.allocator.num_blocks)]
              for i, r in rms.items()}
    seqs = {i: {s: ([dataclasses.astuple(rb) for rb in kv.rblocks],
                    kv.num_tokens) for s, kv in r.seqs.items()}
            for i, r in rms.items()}
    return _ledger(g), allocs, seqs


def _rmanager_ops(g, rms, out_of_blocks, seed):
    rng = np.random.default_rng(seed)
    n = len(rms)
    leases = []
    out = []
    for _ in range(150):
        op = rng.integers(0, 7)
        i, j = (int(x) for x in rng.integers(0, n, 2))
        rm = rms[i]
        if op == 0:  # grow a sequence: local blocks, then creditors'
            try:
                added = rm.append_tokens(int(rng.integers(0, 4)),
                                         int(rng.integers(1, 12)))
                out.append([dataclasses.astuple(rb) for rb in added])
            except out_of_blocks:
                out.append("out of blocks")
        elif op == 1:
            rm.free_seq(int(rng.integers(0, 4)))
        elif op == 2:
            out.append(rm.try_lend(j))
        elif op == 3:  # lend live pages of j to i as a zero-copy lease
            live = [b for b in range(rms[j].allocator.num_blocks)
                    if rms[j].allocator.refcount_of(b) > 0]
            pick = [int(b) for b in rng.permutation(
                live + [rms[j].allocator.num_blocks - 1])[:2]]
            res = _outcome(rm.borrow_blocks, j, pick)
            if res[0] == "ok":
                lease = res[1]
                leases.append(lease)
                res = ("ok", lease.home, lease.debtor, lease.blocks,
                       lease.num_tokens, lease.schema)
            out.append(res)
        elif op == 4 and leases:  # a COW sibling shares a lease
            out.append(leases[int(rng.integers(0, len(leases)))]
                       .acquire()._refs)
        elif op == 5 and leases:  # releases past zero are no-ops
            leases.pop(int(rng.integers(0, len(leases)))).release()
        else:
            out.append((rm.remote_fraction(int(rng.integers(0, 4))),
                        g.recommend_creditors(i, 1)))
    out.append(_rmanager_state(g, rms))
    for lease in leases:
        lease.release()
    out.append(_rmanager_state(g, rms))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_rmanager_lending_matches_jax(seed):
    """Sequences that outgrow their instance and borrow from creditors
    (with rollback when the cluster is out of blocks), fresh lends, leases
    over live pages (and refusals of free ones), shared and released
    leases, frees that repay creditors first: the same outcomes, ledger,
    refcounts and rBlocks in both packages."""
    assert _rmanager_ops(*_cluster(GManager, RManager, BlockAllocator),
                         OutOfBlocks, seed) == \
        _rmanager_ops(*_cluster(JaxGManager, JaxRManager, JaxAllocator),
                      JaxOutOfBlocks, seed)


# -- PrefixShareBoard ----------------------------------------------------------------

def _board_dump(node):
    return [(ch.key, ch.payload, ch.home, ch.block, ch.last_access,
             dict(ch.lease_hits), _board_dump(ch))
            for ch in node.children.values()]


def _board_ops(board, seed):
    rng = np.random.default_rng(seed)
    ps = 4
    pins = []
    board.on_pin = lambda home, block: pins.append(("pin", home, block))
    board.on_unpin = lambda home, block: pins.append(("unpin", home, block))
    prefixes = [rng.integers(0, 6, 16).tolist() for _ in range(3)]
    # the first publisher sets the board's page size and schema
    out = [board.publish(0, prefixes[0], list("abcd"), ps,
                         blocks=[40, 41, 42, 43], schema="gqa:test")]
    for step in range(120):
        op = rng.integers(0, 5)
        inst = int(rng.integers(0, 3))
        toks = prefixes[int(rng.integers(0, 3))][:int(rng.integers(0, 17))] \
            + rng.integers(0, 6, int(rng.integers(0, 9))).tolist()
        if op == 0:
            npg = len(toks) // ps
            payloads = [None if rng.random() < 0.3 else f"{inst}:{step}:{i}"
                        for i in range(npg)]
            blocks = [int(b) for b in rng.integers(0, 50, npg)] \
                if rng.random() < 0.6 else None
            out.append(_outcome(board.publish, inst, toks, payloads, ps,
                                blocks, "gqa:test"))
        elif op == 1:
            path = board.match(toks, max_tokens=int(rng.integers(1, 30)))
            out.append([(p.key, p.payload, p.home, p.block) for p in path])
            if path and rng.random() < 0.5:
                out.append(board.record_lease(inst, path))
            out.append(board.lease_hits_of(inst, path))
        elif op == 2:
            out.append(board.covered(toks))
        elif op == 3:
            out.append(_outcome(board.publish, inst, toks[:8], [None, None],
                                8))
        else:
            out.append(_outcome(board.publish, inst, toks[:4], ["x"], ps,
                                None, str(rng.choice(["gqa:test", "mla:x"]))))
    out.append((board.stats(), board.num_pages, pins,
                _board_dump(board._root)))
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("max_pages", [None, 5])
def test_prefix_share_board_matches_jax(seed, max_pages):
    """Publications with and without lendable blocks (pins), payload-less
    pages upgraded with payloads (the pin moves), lookups that touch the
    LRU clock, lease hit counts, covered pages, refusals of a second page
    size or schema, and LRU leaf eviction past ``max_pages``: the same
    answers, pins / unpins and tree in both packages."""
    assert _board_ops(PrefixShareBoard(max_pages=max_pages), seed) == \
        _board_ops(JaxBoard(max_pages=max_pages), seed)


# -- roles and router validation -----------------------------------------------------

@pytest.mark.parametrize("spec", ["2p2d", "1p1d1m", "10d", " 2P1D ",
                                  ("prefill", "mixed"), "", "2pXd", "pd",
                                  "2x", "2p 2d", "p2", "0p",
                                  ("prefill", "gpu")])
def test_parse_role_spec_matches_jax(spec):
    spec = list(spec) if isinstance(spec, tuple) else spec
    got, want = (_outcome(fn, spec)
                 for fn in (parse_role_spec, jax_parse_role_spec))
    assert got == want
    if want[0] == "raised":
        with pytest.raises(ValueError) as jax_err:
            jax_parse_role_spec(spec)
        with pytest.raises(ValueError, match=str(jax_err.value)[:20]):
            parse_role_spec(spec)


def test_instance_spec_refuses_unknown_roles():
    for cls in (InstanceSpec, JaxInstanceSpec):
        with pytest.raises(ValueError, match="role"):
            cls(backend=None, role="router")


@pytest.fixture(scope="module")
def engines():
    """Two smoke OPT engines (no window) and one danube engine (window 64)
    on the CPU; the router reads only their attributes here."""
    def engine(arch, ps=8, **kw):
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32", **kw)
        return PagedEngine(cfg, init_params(cfg, seed=0, device="cpu"),
                           EngineConfig(num_pages=16, page_size=ps,
                                        enable_prefix_cache=True),
                           device="cpu")
    return dict(opt=[engine("paper-opt-13b") for _ in range(2)],
                opt16=engine("paper-opt-13b", ps=16),
                danube=[engine("h2o-danube-1.8b") for _ in range(2)],
                mla=engine("deepseek-v2-236b"))


@pytest.mark.parametrize("kw,match", [
    (dict(prefix_share=True, share_mode="rdma"), "share_mode"),
    (dict(share_mode="zero_copy"), "prefix_share"),
    (dict(roles="2p"), "decode"),
    (dict(roles="2d"), "prefill"),
    (dict(roles="1p2d"), "2"),
    (dict(roles="1p1d", handoff_mode="rdma"), "handoff_mode"),
])
def test_router_refuses_bad_configurations(engines, kw, match):
    with pytest.raises(ValueError, match=match):
        RouterBackend(engines["opt"], **kw)


def test_router_refuses_mixed_pages_and_windowed_zero_copy(engines):
    """Engine children: prefix sharing needs one page size and one KV
    layout schema; a zero-copy handoff refuses sliding-window children
    (the remote partial ignores the window), which migrate accepts. An
    all-mixed role spec is the plain router."""
    with pytest.raises(ValueError, match="page size"):
        RouterBackend([engines["opt"][0], engines["opt16"]],
                      prefix_share=True)
    with pytest.raises(ValueError, match="schema"):
        RouterBackend([engines["opt"][0], engines["mla"]], prefix_share=True)
    with pytest.raises(ValueError, match="sliding-window"):
        RouterBackend(engines["danube"], roles="1p1d",
                      handoff_mode="zero_copy")
    r = RouterBackend(engines["danube"], roles="1p1d", handoff_mode="auto")
    assert r.disaggregated and not r.handoff_zc_ok and not r.rms
    r = RouterBackend(engines["opt"], roles="2m")
    assert r.handoff is None and not r.disaggregated


def test_router_wires_engine_children(engines):
    """Zero-copy sharing wires every engine's remote_reader to the peers'
    pools (read in place, not copied) and the board's pins to the home
    allocators; copy sharing wires importers and no reader."""
    a, b = (PagedEngine(e.cfg, e.params, e.ecfg, device="cpu")
            for e in engines["opt"])
    r = RouterBackend([a, b], prefix_share=True, share_mode="zero_copy")
    assert a.remote_reader(1)[0] is b.k_pages
    assert b.remote_reader(0)[1] is a.v_pages
    assert b.scheduler.remote_adopter is not None
    assert b.scheduler.prefix_importer is None
    blk = a.allocator.alloc_block()
    r.g.prefix_board.on_pin(0, blk)
    assert a.allocator.refcount_of(blk) == 2
    r.g.prefix_board.on_unpin(0, blk)
    assert a.allocator.refcount_of(blk) == 1
    c, d = (PagedEngine(e.cfg, e.params, e.ecfg, device="cpu")
            for e in engines["opt"])
    RouterBackend([c, d], prefix_share=True, share_mode="copy")
    assert c.remote_reader is None and c.scheduler.prefix_importer
