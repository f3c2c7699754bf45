from repro_torch.core.scheduling.request import Phase, Request  # noqa: F401
from repro_torch.core.scheduling.iteration import (  # noqa: F401
    CHUNK_POLICIES, IterationPlan, IterationScheduler, PrefillChunk)
