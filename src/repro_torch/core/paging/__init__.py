from repro_torch.core.paging.allocator import (  # noqa: F401
    BlockAllocator, BlockTable, ContiguousPreallocAllocator, OutOfBlocks,
    OutOfHostBlocks)
from repro_torch.core.paging.layout import (  # noqa: F401
    KVPageLayout, PoolSpec, check_schema)
