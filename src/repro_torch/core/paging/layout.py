"""KVPageLayout: the per-arch KV page-payload schema.

One page of KV cache is a fixed number of token slots, but *what a token
slot holds* depends on the attention flavor:

* ``gqa`` — two pools of per-head tensors: ``k``/``v`` with token shape
  ``(num_kv_heads, head_dim)`` each (also plain MHA / SWA).
* ``mla`` — two pools of *shared latent* vectors (DeepSeek-V2 Multi-head
  Latent Attention): ``ckv`` with token shape ``(kv_lora_rank,)`` and
  ``krope`` with token shape ``(qk_rope_head_dim,)`` — ~10x fewer bytes
  per token than the equivalent GQA layout.

Every subsystem that sizes, moves, or shares KV pages derives its numbers
from this object instead of assuming the GQA shape:

* the engine allocates its device/host pools from :meth:`pool_shapes`;
* the allocator exposes :attr:`page_bytes` for cost models;
* ``NetworkModel`` charges swap / peer-copy / adoption from the layout's
  actual bytes-per-page (compressed layouts transfer ~10x less);
* the share board, remote leases, and KV handoff carry :attr:`schema` and
  reject mismatched layouts loudly instead of corrupting pages.

The schema tag (e.g. ``"mla:ckv512+krope64:bf16"``) is the wire contract:
two instances may exchange page payloads iff their tags are equal.

This module is dependency-free (no jax) so the sim / cost-model side can
use it without pulling in the numerics stack.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# bytes per element for the dtype names ArchConfig uses
_DTYPE_BYTES = {
    "bfloat16": 2, "float16": 2, "float32": 4, "float64": 8,
    "int8": 1, "uint8": 1, "fp8": 1, "float8_e4m3fn": 1, "float8_e5m2": 1,
}


def _dtype_nbytes(name: str) -> int:
    try:
        return _DTYPE_BYTES[name]
    except KeyError:
        raise ValueError(f"unknown KV dtype {name!r}") from None


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """One physical page pool: ``name`` plus the per-token payload shape.

    A pool array is ``(num_layers, num_pages, page_size, *token_shape)``;
    every page-granular operation (COW, swap, spill, export) indexes only
    the pages axis, so the trailing ``token_shape`` is opaque to it.
    """

    name: str
    token_shape: Tuple[int, ...]

    @property
    def token_elems(self) -> int:
        return math.prod(self.token_shape)


@dataclasses.dataclass(frozen=True)
class KVPageLayout:
    """Attention flavor + page pool specs + dtype = the page schema."""

    flavor: str  # "gqa" | "mla"
    pools: Tuple[PoolSpec, ...]
    dtype_name: str
    num_layers: int

    @classmethod
    def from_arch(cls, cfg) -> "KVPageLayout":
        """Derive the layout from an ``ArchConfig``. A stack that lists its
        layers' mixers (``layer_types``) pages only its attention layers:
        the others keep no KV."""
        types = getattr(cfg, "layer_types", None)
        layers = cfg.num_layers if types is None \
            else sum(t == "attention" for t in types)
        if getattr(cfg, "attention", None) == "mla":
            pools = (PoolSpec("ckv", (cfg.kv_lora_rank,)),
                     PoolSpec("krope", (cfg.qk_rope_head_dim,)))
            return cls("mla", pools, cfg.dtype, layers)
        pools = (PoolSpec("k", (cfg.num_kv_heads, cfg.head_dim)),
                 PoolSpec("v", (cfg.num_kv_heads, cfg.head_dim)))
        return cls("gqa", pools, cfg.dtype, layers)

    # -- byte accounting ----------------------------------------------------
    @property
    def dtype_bytes(self) -> int:
        return _dtype_nbytes(self.dtype_name)

    @property
    def bytes_per_token_layer(self) -> int:
        """KV bytes one token occupies in one layer, summed over pools."""
        return sum(p.token_elems for p in self.pools) * self.dtype_bytes

    @property
    def bytes_per_token(self) -> int:
        """KV bytes one token occupies across the whole stack."""
        return self.bytes_per_token_layer * self.num_layers

    def page_bytes(self, page_size: int) -> int:
        """Wire/HBM bytes of one logical page (all layers, all pools)."""
        return self.bytes_per_token * page_size

    # -- pool geometry ------------------------------------------------------
    def pool_shapes(self, num_pages: int, page_size: int):
        """Physical array shape per pool: (L, num_pages, page_size, *token)."""
        return tuple((self.num_layers, num_pages, page_size) + p.token_shape
                     for p in self.pools)

    # -- wire contract ------------------------------------------------------
    @property
    def schema(self) -> str:
        """Canonical schema tag, e.g. ``"gqa:k8x64+v8x64:bf16"``.

        Equal tags <=> page payloads are interchangeable. Carried on board
        publishes, remote leases, and handoff payloads; every import side
        validates it and raises instead of adopting foreign bytes.
        """
        pools = "+".join(
            f"{p.name}{'x'.join(str(d) for d in p.token_shape)}"
            for p in self.pools)
        short = {"bfloat16": "bf16", "float16": "f16", "float32": "f32"}
        return f"{self.flavor}:{pools}:{short.get(self.dtype_name, self.dtype_name)}"


def check_schema(expected: str, got, *, where: str) -> None:
    """Loud layout-mismatch guard used by every page-payload import path."""
    if got is not None and got != expected:
        raise ValueError(
            f"KV layout schema mismatch at {where}: local layout is "
            f"{expected!r} but payload/peer carries {got!r}; refusing to "
            "adopt foreign page bytes (would corrupt pages)")
