"""Paper Fig. 10 on the port: DistKV-LLM (gManager/rManager borrowing) vs
vanilla paged instances, sweeping the long-request fraction (1% / 5% / 10%).

A copy of ``benchmarks/serving_fig10.py`` that imports only ``repro_torch``,
so it runs on a machine without JAX; ``run(...)`` takes the reference's
arguments and returns its rows. Throughputs are tokens per second of the
virtual clock of ``CostModel``'s defaults (the reference's assumed
A100-like terms), not rates measured on any card.

Two regimes:
* long context FITS one instance  -> DistKV reduces preemption/queueing;
* long context EXCEEDS one instance -> the baseline must reject; DistKV is
  the only system that serves those requests at all (completion rate).

A third column replays the same trace through the LLMService front-end over
a single pooled-memory SimBackend (all instances' blocks in one allocator)
— the upper bound DistKV's borrowing approaches.

  PYTHONPATH=src python benchmarks/torch_serving_fig10.py
"""

from __future__ import annotations

from repro_torch.serving.api import LLMService
from repro_torch.serving.simulator import (SimBackend, make_workload,
                                           simulate_distkv)

N_INSTANCES = 4


def _pooled(wl, blocks_per_instance: int):
    """Single pooled instance with the cluster's total KV memory, fronted by
    LLMService (what perfect borrowing would look like)."""
    svc = LLMService(SimBackend(
        num_blocks=N_INSTANCES * blocks_per_instance, block_size=16,
        max_running=256))
    _, stats = svc.replay(wl())
    return stats


def run(n_requests: int = 240, verbose: bool = True):
    out = []
    for regime, long_len, bpi in (("fits", 10_000, 800),
                                  ("exceeds", 20_000, 800)):
        for lf in (0.01, 0.05, 0.10):
            wl = lambda: make_workload(n_requests, rate=12.0,
                                       dist="sharegpt", seed=1,
                                       long_frac=lf, long_len=long_len,
                                       max_len=2048)
            rd = simulate_distkv(wl(), borrow=True, blocks_per_instance=bpi,
                                 n_instances=N_INSTANCES)
            rn = simulate_distkv(wl(), borrow=False, blocks_per_instance=bpi,
                                 n_instances=N_INSTANCES)
            pooled = _pooled(wl, bpi)
            row = dict(regime=regime, long_frac=lf,
                       distkv_thr=rd.throughput_tokens_per_s,
                       distkv_done=rd.completed_frac,
                       local_thr=rn.throughput_tokens_per_s,
                       local_done=rn.completed_frac,
                       local_rejected=rn.rejected,
                       local_preempt=rn.preemptions,
                       pooled_thr=pooled.throughput_tokens_per_s,
                       pooled_done=pooled.completed_frac,
                       gain=rd.throughput_tokens_per_s /
                       max(rn.throughput_tokens_per_s, 1e-9))
            out.append(row)
            if verbose:
                print(f"[{regime:7s}] long={lf:4.0%}: "
                      f"DistKV {row['distkv_thr']:6.0f} tok/s "
                      f"(done {row['distkv_done']:.0%}) | "
                      f"local {row['local_thr']:6.0f} tok/s "
                      f"(done {row['local_done']:.0%}, "
                      f"rej {row['local_rejected']}, "
                      f"pre {row['local_preempt']}) | "
                      f"pooled {row['pooled_thr']:6.0f} tok/s "
                      f"(done {row['pooled_done']:.0%}) | "
                      f"gain {row['gain']:.2f}x")
    return out


if __name__ == "__main__":
    run()
