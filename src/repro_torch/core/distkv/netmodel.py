"""Network/serialization cost model for cross-instance KV movement.

The cluster router can serve a published prefix to a peer instance two ways,
and both cost real network time that the virtual-clock simulator must charge
(a copy looked free before, which made every comparison flatter it):

* **copy** — ship the page payloads once and adopt them into the peer's own
  radix tree. Cost: per-page serialization/RPC overhead plus payload bytes
  over the interconnect, paid once per adopting instance; serving afterwards
  is local.
* **borrow (zero-copy)** — lease the home instance's physical pages
  (rBlocks) and serve them in place through the DistAttention partial
  ``(o, m, l)`` merge. Cost: a small lease RPC up front, then a per-iteration
  merge round plus remote context reads for as long as the borrower decodes.

``prefer_borrow`` is the myopic per-request decision ``share_mode="auto"``
uses: borrow when the estimated lifetime borrow overhead undercuts the
one-time payload transfer — hot *short* prefixes with modest decode lengths
borrow, long prefixes ahead of long decodes copy. The crossover is measured
by ``benchmarks/zero_copy_sweep.py``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class NetworkModel:
    """Per-page transfer latency + bandwidth, and partial-merge overhead.

    Defaults sketch a 100 Gb/s datacenter link serving OPT-13B-ish pages
    (2 [K+V] * 16 tokens * 40 layers * 5120 dim * 2 bytes ~= 13 MB/page).
    """

    gbps: float = 100.0          # interconnect bandwidth
    # serialized payload of one page under the *default* (GQA-ish) layout.
    # Every byte-charging method takes an optional per-call ``page_bytes``
    # override so compressed layouts (MLA latent pages are ~10x smaller)
    # are charged their actual wire bytes — see ``KVPageLayout.page_bytes``
    # and :meth:`for_layout`.
    page_bytes: int = 13_107_200  # serialized K+V payload of one page
    t_page_fixed: float = 40e-6  # per-page serialization + RPC overhead
    t_lease_fixed: float = 20e-6  # one-time lease/borrow RPC per request
    # one partial (o, m, l) merge round per borrowing request per iteration:
    # the partials are tiny (per-head stats), so this is latency, not bytes
    t_merge: float = 30e-6
    # remote context read per borrowed token per iteration (DistAttention
    # computes the micro-attention where the block lives and ships only the
    # partials, so this is coordination cost, not a page read — mirrors
    # CostModel.c_remote)
    c_remote_token: float = 6e-9
    # host swap lane: device<->host page movement rides PCIe, not the
    # interconnect. 256 Gb/s = 32 GB/s, a PCIe 5.0 x16 link's practical
    # throughput; t_swap_fixed covers the DMA setup per batched transfer
    pcie_gbps: float = 256.0
    t_swap_fixed: float = 20e-6
    # peer spill lane: device->device page movement between co-located
    # instances rides an NVLink-class link — much wider than the PCIe host
    # lane, which is what makes a neighbor's free device memory a better
    # spill target than host when one is available
    nvlink_gbps: float = 600.0

    @classmethod
    def for_layout(cls, layout, page_size: int, **overrides) -> "NetworkModel":
        """A model whose default ``page_bytes`` matches a ``KVPageLayout``."""
        overrides.setdefault("page_bytes", layout.page_bytes(page_size))
        return cls(**overrides)

    def _pb(self, page_bytes) -> int:
        return self.page_bytes if page_bytes is None else page_bytes

    def swap_time(self, n_pages: int, *, page_bytes: int = None) -> float:
        """One direction of a swap: ``n_pages`` over PCIe plus one DMA
        setup. A swap round trip (out now, in later) costs twice this."""
        if n_pages <= 0:
            return 0.0
        wire = self._pb(page_bytes) * 8.0 / (self.pcie_gbps * 1e9)
        return self.t_swap_fixed + n_pages * wire

    def peer_copy_time(self, n_pages: int, *, page_bytes: int = None) -> float:
        """One direction of a peer spill/restore: ``n_pages`` device pages
        moved to/from a neighbor instance over the NVLink-class lane, plus
        one transfer setup."""
        if n_pages <= 0:
            return 0.0
        wire = self._pb(page_bytes) * 8.0 / (self.nvlink_gbps * 1e9)
        return self.t_swap_fixed + n_pages * wire

    def page_copy_time(self, n_pages: int, *, page_bytes: int = None) -> float:
        """One-time payload transfer of ``n_pages`` (copy-mode adoption)."""
        wire = self._pb(page_bytes) * 8.0 / (self.gbps * 1e9)
        return n_pages * (self.t_page_fixed + wire)

    def lease_time(self, n_pages: int) -> float:
        """Borrow setup: one RPC, block ids only (no payload)."""
        return self.t_lease_fixed

    def borrow_iter_overhead(self, n_borrowing: int) -> float:
        """Per-iteration merge cost for ``n_borrowing`` requests whose
        attention gathered remote partials this iteration."""
        return n_borrowing * self.t_merge

    def borrow_lifetime_cost(self, n_pages: int, page_size: int,
                             est_decode_tokens: int) -> float:
        """Estimated total overhead of serving a prefix remotely for one
        request's lifetime (~one iteration per decoded token)."""
        per_iter = self.t_merge + self.c_remote_token * n_pages * page_size
        return self.lease_time(n_pages) + est_decode_tokens * per_iter

    def prefer_borrow(self, n_pages: int, page_size: int,
                      est_decode_tokens: int,
                      expected_reuse: float = 1.0, *,
                      page_bytes: int = None) -> bool:
        """The ``share_mode="auto"`` decision for one admission.

        ``expected_reuse`` amortizes the one-time copy across the requests
        expected to hit the same prefix on this instance (the share board's
        per-(instance, prefix) lease hit-count plus this one): a prefix that
        keeps getting leased tips toward copying, because the payload
        transfer is paid once while every borrower pays merge overhead for
        its whole decode. ``expected_reuse=1`` is the original myopic
        per-request decision."""
        copy_amortized = self.page_copy_time(
            n_pages, page_bytes=page_bytes) / max(expected_reuse, 1.0)
        return self.borrow_lifetime_cost(
            n_pages, page_size, est_decode_tokens) < copy_amortized
