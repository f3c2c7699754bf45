"""Chain selection for a PETALS-style swarm (a copy of
``repro.core.chain`` with its imports changed)."""

from repro_torch.core.chain.registry import (  # noqa: F401
    Fleet, ServerInfo, make_fleet)
from repro_torch.core.chain.baseline import (  # noqa: F401
    Chain, find_best_chain)
from repro_torch.core.chain.nsga2 import nsga2, hypervolume_2d  # noqa: F401
from repro_torch.core.chain.tradeoff import (  # noqa: F401
    ChainSequenceProblem, latency_throughput_tradeoff, decode_chain,
    knee_chain)
