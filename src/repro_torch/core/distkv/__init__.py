from repro_torch.core.distkv.gmanager import GManager, Heartbeat, DebtEntry  # noqa: F401
from repro_torch.core.distkv.netmodel import NetworkModel  # noqa: F401
from repro_torch.core.distkv.prefixshare import (  # noqa: F401
    PrefixShareBoard, PublishedPage)
from repro_torch.core.distkv.rmanager import (  # noqa: F401
    RManager, RBlock, RemoteLease, SeqKV)
from repro_torch.core.distkv.dist_attention import (  # noqa: F401
    attention_partial, dist_attention, dist_attention_ref,
    merge_partials, merge_partials_tree, micro_attention_partial)
