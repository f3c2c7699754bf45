"""InfiniteLLM-style distributed KV cluster on the port: four serving
instances, one gets a burst of long-context requests, borrows rBlocks
through the gManager debt ledger, and repays on completion. Also runs the
DistAttention micro-attention merge over a ``(data, model)`` device mesh.
The port of ``examples/distributed_kv_cluster.py``.

  PYTHONPATH=src python examples/torch_distributed_kv_cluster.py [--device cpu]
  PYTHONPATH=src torchrun --nproc-per-node 8 \\
      examples/torch_distributed_kv_cluster.py --device cpu

Run alone, DistAttention runs on a one-rank process group (a 1 x 1 mesh);
under ``torchrun`` with 8 ranks on a 2 x 4 mesh, the KV sharded over the 4
model ranks. The ledger and the cluster simulation run on the host, on
rank 0 only.
"""

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.core.distkv import (GManager, RManager, dist_attention,
                                     dist_attention_ref)
from repro_torch.core.paging import BlockAllocator
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (init_distributed, make_host_mesh,
                                     mesh_sizes)
from repro_torch.serving.simulator import make_workload, simulate_distkv


def debt_ledger_demo() -> dict:
    print("== gManager debt ledger (paper Fig. 8) ==")
    g = GManager(4)
    rms = {i: RManager(i, BlockAllocator(16, 16), g) for i in range(4)}
    for r in rms.values():
        r.register_peers(rms)

    rms[0].append_tokens(seq_id=100, new_tokens=16 * 14)  # near-full
    rms[0].append_tokens(seq_id=101, new_tokens=16 * 6)   # must borrow
    rms[3].append_tokens(seq_id=300, new_tokens=16 * 15)
    rms[3].append_tokens(seq_id=301, new_tokens=16 * 3)

    snap = g.snapshot()
    print(f"{'inst':>4} {'free/total':>12}  debtors")
    for i, row in snap.items():
        debt = ", ".join(f"inst{d} owes {b} blk" for d, b in row["debtors"])
        print(f"{i:>4} {row['free']:>5}/{row['total']:<6} {debt or '-'}")
    remote = rms[0].remote_fraction(101)
    print(f"instance 0 seq 101 remote fraction: {remote:.0%}")
    rms[0].free_seq(101)
    print(f"after repay, ledger entries: {len(g.ledger)}")
    return dict(remote_fraction=remote, ledger_entries=len(g.ledger))


def dist_attention_demo(dev) -> float:
    """DistAttention over this process's group (made here, and destroyed
    after, unless one exists): a 2 x 4 mesh on 8 ranks, 1 x 1 alone.
    Returns the merge's max error against the unsharded oracle."""
    made = not dist.is_initialized()
    rank = init_distributed(dev)
    try:
        if rank == 0:
            print("\n== DistAttention: sequence-sharded micro-attention ==")
        mesh = make_host_mesh(4, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        b, h, hkv, dh, s = 4, 8, 2, 64, 512
        q = torch.randn(b, h, dh, generator=gen, device=dev)
        k = torch.randn(b, s, hkv, dh, generator=gen, device=dev)
        v = torch.randn(b, s, hkv, dh, generator=gen, device=dev)
        lens = torch.tensor([100, 512, 7, 300], dtype=torch.int32,
                            device=dev)
        out = dist_attention(mesh, q, k, v, lens).to_local()
        want = dist_attention_ref(q, k, v, lens)
        err = float((out - want).abs().max())
        if rank == 0:
            print(f"KV sharded over {mesh_sizes(mesh)['model']} model "
                  f"shards; merge error vs unsharded oracle: {err:.2e}")
    finally:
        if made:
            dist.destroy_process_group()
    return err


def cluster_sim_demo() -> dict:
    print("\n== cluster simulation: borrow vs no-borrow ==")
    wl = lambda: make_workload(160, rate=12.0, dist="sharegpt", seed=1,
                               long_frac=0.08, long_len=10_000, max_len=2048)
    rd = simulate_distkv(wl(), borrow=True, blocks_per_instance=800)
    rn = simulate_distkv(wl(), borrow=False, blocks_per_instance=800)
    print(f"DistKV (borrow): {rd.throughput_tokens_per_s:6.0f} tok/s, "
          f"completed {rd.completed_frac:.0%}, preemptions {rd.preemptions}")
    print(f"local-only     : {rn.throughput_tokens_per_s:6.0f} tok/s, "
          f"completed {rn.completed_frac:.0%}, preemptions {rn.preemptions}")
    return dict(borrow_tokens_per_s=rd.throughput_tokens_per_s,
                local_tokens_per_s=rn.throughput_tokens_per_s,
                borrow_preemptions=rd.preemptions,
                local_preemptions=rn.preemptions)


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    lead = int(os.environ.get("RANK", "0")) == 0
    out = {"ledger": debt_ledger_demo()} if lead else {}
    out["dist_attention_err"] = dist_attention_demo(dev)
    if lead:
        out["sim"] = cluster_sim_demo()
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never a fallback")
    main(ap.parse_args().device)
