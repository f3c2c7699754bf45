"""Disaggregated prefill/decode serving: roles, placement, KV handoff (a
copy of ``repro.serving.disagg`` with its imports changed).

Chunked prefill *interleaves* prefill and decode inside one
instance; disaggregation (DistServe / Splitwise style) *separates* them.
A cluster is declared as role-tagged instances — ``InstanceSpec`` wraps a
child backend with a role:

* ``prefill`` — runs chunked prefill only. Its scheduler is put in
  ``prefill_only`` mode: it admits and chunks prompts at full token budget
  but never plans a decode, so prefill throughput is never taxed by decode
  batching and decode latency is never spiked by a co-scheduled chunk.
* ``decode``  — never sees a new prompt (the router only places arrivals on
  prefill-capable instances); its iterations are pure decode batches whose
  time is the small per-token cost, which is the whole point: P99 TBT drops
  from "budget-sized mixed iteration" to "decode-only iteration".
* ``mixed``   — the pre-existing do-both behavior (the default when a bare
  backend is passed, so an all-``mixed`` router is exactly the old one).

The seam between the roles is the **KV handoff**: when a prefill instance
finishes a prompt's final chunk (the request has its first token and is
sitting in ``Phase.INCREMENT`` with nowhere to decode), the
:class:`KVHandoff` coordinator moves its prompt KV to a decode instance
chosen by :class:`DecodePlacement` and re-homes the request mid-flight.
The move reuses the cross-instance KV machinery of prefix sharing,
per-request:

* **migrate** — ``export_page_payload`` on the prefill host, fresh blocks +
  ``import_page_payloads`` on the decode host. One payload transfer,
  charged as ``NetworkModel.page_copy_time``; afterwards decode is fully
  local and the prefill host's pages are free for the next prompt.
* **zero_copy** — a :class:`~repro_torch.core.distkv.rmanager.RemoteLease`
  on the prefill host's physical pages, served in place through the
  DistAttention partial merge. Near-instant handoff (``lease_time``), but the decode
  host pays a merge per iteration and the prefill host's pages stay pinned
  for the request's lifetime. Unlike an admission-time prefix lease (capped
  at ``prompt_len - 1`` so the final token's logits are computed locally),
  a handoff lease covers **all full prompt pages** — the first token was
  already sampled on the prefill host; only a partial tail page is copied.
* **auto** — ``NetworkModel.prefer_borrow`` per request on the remaining
  decode length: short decodes borrow, long decodes amortize a copy.

Telemetry: each handoff is a ``handoff.kv`` begin/end span on the router
track (begin stamped at the prefill host's clock, end at the decode host's
clock after transfer charges), and a leased handoff emits the same
``lease.acquire`` instant on the decode instance's tracer that an
admission-time lease would, so lease acquire/release events balance per
(instance, request) no matter which host finishes the request.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, List, Optional, Sequence, Union

from repro_torch.core.paging.allocator import BlockTable, OutOfBlocks
from repro_torch.core.scheduling.request import Phase, Request

ROLES = ("prefill", "decode", "mixed")
HANDOFF_MODES = ("migrate", "zero_copy", "auto")

_ROLE_OF_LETTER = {"p": "prefill", "d": "decode", "m": "mixed"}


@dataclasses.dataclass
class InstanceSpec:
    """One cluster member: a constructed child backend plus its role.

    ``RouterBackend`` accepts bare backends (role ``mixed`` — the previous
    N-identical-children behavior) or ``InstanceSpec``s, mixed freely."""

    backend: Any
    role: str = "mixed"

    def __post_init__(self):
        if self.role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, "
                             f"got {self.role!r}")


def parse_role_spec(spec: Union[str, Sequence[str]]) -> List[str]:
    """Expand a role spec into a per-instance role list.

    The compact string grammar is ``(<count><p|d|m>)+``: ``"2p2d"`` is two
    prefill + two decode instances, ``"1p2d1m"`` adds a mixed one. A
    sequence of role names (``["prefill", "decode"]``) passes through
    validated. Raises ValueError with the grammar on anything malformed."""
    if isinstance(spec, (list, tuple)):
        roles = list(spec)
        for r in roles:
            if r not in ROLES:
                raise ValueError(f"unknown role {r!r}: roles are {ROLES}")
        return roles
    s = str(spec).strip().lower()
    if not re.fullmatch(r"(?:\d+[pdm])+", s):
        raise ValueError(
            f"malformed role spec {spec!r}: expected one or more "
            f"<count><p|d|m> groups, e.g. '2p2d' = 2 prefill + 2 decode "
            f"instances (p=prefill, d=decode, m=mixed)")
    roles: List[str] = []
    for count, letter in re.findall(r"(\d+)([pdm])", s):
        roles.extend([_ROLE_OF_LETTER[letter]] * int(count))
    if not roles:
        raise ValueError(f"role spec {spec!r} names zero instances")
    return roles


class DecodePlacement:
    """Pick the decode instance that receives a finished prefill's KV.

    Free-slot- and lease-aware least-loaded: candidates are the
    decode-capable instances (role ``decode`` or ``mixed``, excluding the
    prefill host) that have a free decode slot and room for the pages the
    handoff will materialize; among those, fewest queued+running requests
    wins, then the smallest outstanding borrowed-page debt (every borrowed
    page is a partial-merge round the instance keeps paying each
    iteration — a debt-laden instance is slower than its queue length
    suggests), then the most free KV pages."""

    name = "decode_placement"

    def choose(self, router, *, exclude: int,
               needed_pages: int) -> Optional[int]:
        best, best_key = None, None
        for i in router.decode_capable:
            if i == exclude:
                continue
            child = router.children[i]
            slots = getattr(child, "free_decode_slots", None)
            if slots is None:  # sim child: scheduler capacity only
                sched = child.scheduler
                slots = sched.max_running - len(sched.running)
            if slots < 1:
                continue
            free = child.allocator.num_free
            if free < needed_pages:
                continue
            sched = child.scheduler
            load = len(sched.waiting) + len(sched.running)
            key = (load, router.g.borrowed_by(i), -free, i)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best


class KVHandoff:
    """Moves finished-prefill requests from prefill to decode instances.

    Owned by the router; :meth:`drain` runs at the top of every router step
    (a fully-parked prefill instance makes no progress of its own, so the
    handoff cannot ride on an after-step hook). A request with no viable
    decode target stays parked on its prefill host and is retried next
    step — ``deferrals`` counts those waits.

    Deferral is not allowed to become starvation: a request deferred more
    than ``defer_cap`` consecutive times falls back to decoding on its
    prefill host, mixed-style. The rid is added to that scheduler's
    ``decode_exempt`` set (a ``prefill_only`` scheduler plans decodes for
    exempt rids only), so the request finishes locally instead of waiting
    forever on decode capacity that may never appear — its KV is already
    resident there, so fallback costs nothing but the prefill host's
    iteration time. Each wait emits a ``handoff.deferred`` instant and the
    cap trip a ``handoff.fallback`` instant on the router track."""

    def __init__(self, router, *, mode: str = "auto",
                 placement: Optional[DecodePlacement] = None,
                 defer_cap: int = 8):
        if mode not in HANDOFF_MODES:
            raise ValueError(f"handoff_mode must be one of {HANDOFF_MODES}, "
                             f"got {mode!r}")
        if defer_cap < 1:
            raise ValueError(f"defer_cap must be >= 1, got {defer_cap}")
        self.router = router
        self.mode = mode
        self.placement = placement or DecodePlacement()
        self.defer_cap = defer_cap
        self.handoffs_migrated = 0
        self.handoffs_leased = 0
        self.pages_copied = 0
        self.pages_leased = 0
        self.deferrals = 0
        self.fallbacks = 0
        self._defers: dict = {}  # rid -> consecutive failed handoff tries

    @property
    def handoffs(self) -> int:
        return self.handoffs_migrated + self.handoffs_leased

    def drain(self) -> int:
        """Hand off every prefill-complete request parked on a prefill-only
        instance. Returns the number moved this call."""
        moved = 0
        r = self.router
        for p_idx in r.prefill_only:
            sched = r.children[p_idx].scheduler
            ready = [req for req in list(sched.running)
                     if req.phase == Phase.INCREMENT
                     and req.prefilled_len >= req.prompt_len
                     and req.request_id not in sched.decode_exempt]
            for req in ready:
                if self._handoff(p_idx, req):
                    self._defers.pop(req.request_id, None)
                    moved += 1
                else:
                    self._defer(p_idx, req)
        if moved:
            r._heartbeat_all()
        return moved

    def _defer(self, p_idx: int, req: Request) -> None:
        """One more failed handoff try; trip the fallback at the cap."""
        self.deferrals += 1
        rid = req.request_id
        n = self._defers.get(rid, 0) + 1
        self._defers[rid] = n
        r = self.router
        ts = r.children[p_idx].clock()
        tr = r.trace
        if tr is not None:
            tr.instant("handoff", "deferred", rid=rid, ts=ts, src=p_idx,
                       tries=n)
        if n >= self.defer_cap:
            # starvation guard: decode where the KV already lives
            r.children[p_idx].scheduler.decode_exempt.add(rid)
            self._defers.pop(rid, None)
            self.fallbacks += 1
            if tr is not None:
                tr.instant("handoff", "fallback", rid=rid, ts=ts, src=p_idx,
                           tries=n)

    # -- one handoff ------------------------------------------------------------

    def _pick_mode(self, req: Request, full_pages: int,
                   page_size: int) -> str:
        r = self.router
        if self.mode == "migrate" or full_pages == 0 or not r.rms \
                or not r.handoff_zc_ok:
            return "migrate"
        if self.mode == "zero_copy":
            return "zero_copy"
        # auto: remaining decode length is the lease's lifetime — the first
        # token is already out, so the myopic borrow-vs-copy estimate uses
        # what is left, not max_new_tokens
        remaining = max(req.max_new_tokens - len(req.output), 1)
        if r.net is None or r.net.prefer_borrow(
                full_pages, page_size, remaining,
                page_bytes=r._kv_page_bytes(req.instance_id)):
            return "zero_copy"
        return "migrate"

    def _handoff(self, p_idx: int, req: Request) -> bool:
        r = self.router
        p = r.children[p_idx]
        table = p.scheduler.tables.get(req.request_id)
        if table is None:  # raced a finish/preempt — nothing to move
            return False
        ps = p.allocator.block_size
        full = req.prompt_len // ps
        tail = req.prompt_len - full * ps
        mode = self._pick_mode(req, full, ps)
        # pages the decode host must materialize, plus one page of headroom
        # so the first decode append cannot immediately OOM it
        needed = len(table.blocks) if mode == "migrate" else (1 if tail
                                                              else 0)
        d_idx = self.placement.choose(r, exclude=p_idx,
                                      needed_pages=needed + 1)
        if d_idx is None:
            return False  # no viable decode target: stay parked, retry
        d = r.children[d_idx]
        t0 = p.clock()
        if d.clock() is not None and t0 is not None and d.clock() < t0:
            # the KV leaves the prefill host at t0; a virtual decode host
            # idling in the past cannot have installed it earlier
            d.advance_to(t0)
        exp = getattr(p, "export_page_payload", None)
        write = getattr(d, "import_page_payloads", None)
        charge = getattr(d, "charge_network", None)
        m = getattr(d, "metrics", None)
        net = r.net
        lease = None
        if mode == "migrate":
            new_blocks: List[int] = []
            try:
                for _ in table.blocks:
                    new_blocks.append(d.allocator.alloc_block())
            except OutOfBlocks:  # placement raced another grower: roll back
                for b in new_blocks:
                    d.allocator.decref(b)
                return False
            if exp is not None and write is not None:
                write(new_blocks, [exp(b) for b in table.blocks])
            table_d = BlockTable(blocks=new_blocks,
                                 num_tokens=req.prompt_len)
            pages = len(new_blocks)
            if net is not None:
                pb = r._kv_page_bytes(d_idx)
                if charge is not None:
                    charge(net.page_copy_time(pages, page_bytes=pb))
                if m is not None:
                    m.count("net_bytes", r._net_bytes(d_idx, pages))
            self.handoffs_migrated += 1
            self.pages_copied += pages
        else:
            try:
                lease = r.rms[d_idx].borrow_blocks(p_idx,
                                                   table.blocks[:full])
            except (KeyError, ValueError):
                return False  # rBlock wiring missing/stale: retry next step
            tail_blocks: List[int] = []
            if tail:  # the partial tail page is copied, not leased
                tb = d.allocator.alloc_block()
                if exp is not None and write is not None:
                    write([tb], [exp(table.blocks[full])])
                tail_blocks = [tb]
            table_d = BlockTable(blocks=tail_blocks, num_tokens=tail)
            lease.commit()
            pages = full
            if net is not None:
                if charge is not None:
                    charge(net.lease_time(full) +
                           (net.page_copy_time(
                               1, page_bytes=r._kv_page_bytes(d_idx))
                            if tail else 0.0))
                if m is not None:
                    m.count("borrowed_pages", full)
            r.leases_granted += 1
            r.pages_borrowed += full
            self.handoffs_leased += 1
            self.pages_leased += full
            if tail:
                self.pages_copied += 1
        # the prefill side lets go only now that the KV is secured (payloads
        # exported above / blocks lent under the lease): releasing frees its
        # slot and block table without finishing the request
        release = getattr(p, "release_for_handoff", None)
        if release is not None:
            release(req)
        else:
            p.scheduler.release_request(req)
        req.instance_id = d_idx
        r._placement[req.request_id] = d_idx
        install = getattr(d, "install_for_handoff", None)
        if install is not None:
            install(req, table_d, lease)
        else:
            d.scheduler.install_running(req, table_d, lease)
        t1 = d.clock()
        if lease is not None:
            # mirror the admission-time lease.acquire instant on the decode
            # instance's own track: its scheduler will emit the matching
            # lease.release there at finish/preempt
            d_tr = getattr(d.scheduler, "trace", None)
            if d_tr is not None:
                d_tr.instant("lease", "acquire", rid=req.request_id, ts=t1,
                             home=p_idx, tokens=lease.num_tokens,
                             handoff=True)
        tr = r.trace
        if tr is not None:
            tr.begin("handoff", "kv", req.request_id, ts=t0, src=p_idx,
                     dst=d_idx, mode=mode, pages=pages,
                     prompt_len=req.prompt_len)
            tr.end("handoff", "kv", req.request_id, ts=t1)
        return True
