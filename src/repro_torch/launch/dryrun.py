"""Multi-pod dry-run (the port of ``repro.launch.dryrun``): every (arch x
input shape) on the production meshes, in one process, with no device and
no memory: per-rank FLOPs, bytes, collective bytes, the roofline terms
and memory per rank, written as JSON.

The reference lowers and compiles its SPMD program for 256 (512) TPU
chips. The port runs its SPMD program as one rank of a *fake* process
group of 256 (512) ranks (``torch.testing._internal.distributed.
fake_pg``): collectives return at once, and every tensor is a fake
tensor (``FakeTensorMode``) of the rank's local shard, so a 123 B
parameter model costs no memory. A dispatch mode (:class:`Counter`) sees
each op the rank runs on its local tensors, beneath DTensor, and counts
its FLOPs, bytes and collectives (``repro_torch.roofline.analysis``).
Every rank of the mesh runs the same program on equal shapes (the layout
rules shard only what divides), so rank 0's counts are every rank's.

It counts the full depth by default; ``--cap N`` (N >= 2) caps every
segment at N and N + 2 layers and extrapolates linearly, as the reference
does (``--cap 2`` is the reference's 2 and 4). A segment of one layer is
stored without its layer axis and laid out otherwise, so a cap of 1
would not be linear.

  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch h2o-danube-1.8b --shape train_4k [--multi-pod] \\
      [--out bench_out/torch_dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all

It needs no GPU and imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import weakref
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, get_config,
                                 input_specs)
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import Model
from repro_torch.roofline import analysis
from repro_torch.training import optimizer
from repro_torch.training.train_loop import make_train_step

OUT_DIR = os.path.join("bench_out", "torch_dryrun")

# functional collectives by the reference's kinds
_COLL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_FREE = {"detach", "alias", "lift_fresh", "wait_tensor", "_local_scalar_dense",
         "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
         "empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_to_copy_noop"}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class Counter(TorchDispatchMode):
    """Counts what this rank runs on its local tensors: FLOPs of the
    matmul-class ops, input + output bytes of every other op that is not
    a view, the output bytes of every collective by kind, and the peak of
    the bytes the ops' outputs hold alive (each output that owns its
    storage, from its op until it is freed). An op on DTensors is not
    counted itself: the mode re-enters for the local ops DTensor runs."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives = defaultdict(int)
        self.live = 0
        self.peak = 0
        self.ops = 0

    def _track(self, out):
        for t in _tensors(out):
            if t._base is not None:
                continue
            n = _nbytes(t)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, n)

    def _free(self, n):
        self.live -= n

    # >0 while DTensor infers an output's global shape on fake tensors
    paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # DTensor's own dispatch runs; its local ops come back here
            return NotImplemented
        out = func(*args, **kwargs)
        if Counter.paused:
            return out
        self.ops += 1
        packet = func._overloadpacket
        name = packet.__name__
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d_functional", "_dtensor"):
            kind = "all-to-all" if name == "shard_dim_alltoall" \
                else _COLL.get(name)
            if kind:
                self.collectives[kind] += sum(_nbytes(t)
                                              for t in _tensors(out))
            self._track(out)
            return out
        if packet in self._flop:
            self.flops += self._flop[packet](*args, **kwargs, out_val=out)
        if not (func.is_view or name in _FREE):
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        self._track(out)
        return out


def _alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's shard-to-shard move as the all-to-all a GPU mesh runs (a
    CPU mesh falls back to an all-gather and a chunk)."""
    import torch.distributed._functional_collectives as funcol
    n = mesh.size(mesh_dim)
    parts = torch.stack(list(input.chunk(n, dim=shard_dim)))
    got = funcol.wait_tensor(funcol.all_to_all_single(
        parts.contiguous(), None, None, (mesh, mesh_dim)))
    return torch.cat(list(got.unbind(0)), dim=gather_dim).contiguous()


@contextlib.contextmanager
def _real_index_math():
    """DTensor computes a strided shard's local size on an index tensor
    (``_StridedShard.local_shard_size_and_offset``), which a fake tensor
    cannot answer: that bookkeeping runs on real tensors, unseen by the
    counter."""
    from torch.distributed.tensor import placement_types as pt
    from torch.utils._python_dispatch import _disable_current_modes
    cls = getattr(pt, "_StridedShard", None)
    raw = cls.__dict__.get("local_shard_size_and_offset") if cls else None
    if raw is None:
        yield
        return
    fn = raw.__func__ if isinstance(raw, (staticmethod, classmethod)) \
        else raw

    def real(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)

    wrapped = type(raw)(real) if isinstance(
        raw, (staticmethod, classmethod)) else real
    setattr(cls, "local_shard_size_and_offset", wrapped)
    try:
        yield
    finally:
        setattr(cls, "local_shard_size_and_offset", raw)


@contextlib.contextmanager
def _unseen_shape_inference():
    """DTensor infers an op's global output shape by running it on fake
    tensors of the global shapes; the counter skips those runs."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    raw = ShardingPropagator.__dict__.get("_propagate_tensor_meta_non_cached")
    if raw is None:
        yield
        return

    def paused(*args, **kwargs):
        Counter.paused += 1
        try:
            return raw(*args, **kwargs)
        finally:
            Counter.paused -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = paused
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = raw


@contextlib.contextmanager
def _gpu_alltoall():
    from torch.distributed.tensor import _collective_utils as cu
    from torch.distributed.tensor import _redistribute as rd
    saved = cu.shard_dim_alltoall, getattr(rd, "shard_dim_alltoall", None)
    cu.shard_dim_alltoall = _alltoall
    if saved[1] is not None:
        rd.shard_dim_alltoall = _alltoall
    try:
        yield
    finally:
        cu.shard_dim_alltoall = saved[0]
        if saved[1] is not None:
            rd.shard_dim_alltoall = saved[1]


def join_fake_group(world: int) -> None:
    """This process as rank 0 of a fake group of ``world`` ranks (a
    group of another size is left first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def skip_reason(cfg, shape) -> str:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("full quadratic attention at 524k decode is out of scope for "
                "this arch (no sliding-window/SSM path) — see DESIGN.md §4")
    return ""


def _cap_plan(model: Model, cap: int) -> int:
    """Cap every stacked segment at ``cap`` layers; the capped total."""
    model.plan = [dataclasses.replace(s, n=min(s.n, cap))
                  for s in model.plan]
    model.enc_plan = [dataclasses.replace(s, n=min(s.n, cap))
                      for s in model.enc_plan]
    return sum(s.n for s in model.plan + model.enc_plan)


def _fake_params(model: Model):
    """The parameter tree of ``model``'s (possibly capped) plan."""
    from repro_torch.bridge import init_params
    return init_params(model.cfg, seed=0, device="cpu", plan=model.plan,
                       enc_plan=model.enc_plan)


def _batch(cfg, shape):
    """Token batches of ``input_specs`` (zeros: a fake run reads no
    value)."""
    return {k: torch.zeros(s.shape, dtype=s.dtype)
            for k, s in input_specs(cfg, shape).items()}


def build(cfg, shape, mesh, *, cap: int = 0):
    """(step callable of no arguments, argument bytes per rank, the capped
    layer count or None): the reference's train / prefill / decode step
    on ``mesh`` over fake DTensors. Call inside ``FakeTensorMode``."""
    model = Model(cfg, remat=shape.kind == "train")
    n_layers = _cap_plan(model, cap) if cap else None
    policy = shd.MeshPolicy(mesh, cfg, decode=shape.kind == "decode",
                            megatron=shd.megatron_layout())
    params = _fake_params(model)
    params = shd.distribute(params, shd.param_specs(params, mesh, cfg), mesh)
    batch = _batch(cfg, shape)
    batch = shd.distribute(batch, shd.batch_specs(batch, mesh, cfg), mesh)
    args = [params, batch]

    if shape.kind == "train":
        state = optimizer.init(params)
        args.append(state)
        step = make_train_step(model, optimizer.OptConfig(), policy)

        def run():
            return step(params, state, batch)
    elif shape.kind == "prefill":
        def run():
            return model.prefill(
                params, batch["tokens"], seq_capacity=shape.seq_len,
                media=batch.get("media"),
                encoder_tokens=batch.get("encoder_tokens"), policy=policy)
    else:
        enc_len = shape.seq_len // 4 if cfg.is_encdec else 0
        caches = model.init_cache(shape.global_batch, shape.seq_len,
                                  device="cpu", enc_len=enc_len)
        caches = shd.distribute(caches, shd.cache_specs(
            caches, mesh, cfg, shape.global_batch), mesh)
        args.append(caches)

        def run():
            return model.decode_step(params, batch["tokens"],
                                     batch["positions"], caches,
                                     policy=policy)
    arg_bytes = sum(_nbytes(t.to_local() if hasattr(t, "to_local") else t)
                    for t in _tensors(args))
    return run, arg_bytes, n_layers


def count(cfg, shape, mesh, *, cap: int = 0):
    """Run one step under the counter: (Counter, argument bytes, capped
    layers or None, seconds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.monotonic()
    with FakeTensorMode(allow_non_fake_inputs=True), _gpu_alltoall(), \
            _real_index_math(), _unseen_shape_inference():
        run, arg_bytes, n_layers = build(cfg, shape, mesh, cap=cap)
        c = Counter()
        with c:
            out = run()
        del out, run
    return c, arg_bytes, n_layers, time.monotonic() - t0


def run_one(arch: str, shape_name: str, multi_pod: bool, outdir: str,
            verbose: bool = True, cap: int = 0) -> dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    reason = skip_reason(cfg, shape)
    if reason:
        rec.update(status="skipped", reason=reason)
        _write(rec, outdir)
        if verbose:
            print(f"SKIP {arch} {shape_name} {mesh_name}: {reason}")
        return rec
    join_fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    chips = mesh.size()
    l_full = sum(s.n for s in Model(cfg).plan + Model(cfg).enc_plan)
    if cap == 1:
        raise ValueError("--cap must be 0 (the full depth) or at least 2")
    if cap:
        c2, arg_b, l2, s2 = count(cfg, shape, mesh, cap=cap)
        c4, _, l4, s4 = count(cfg, shape, mesh, cap=cap + 2)
        roof = analysis.extrapolate(analysis.analyze(c2, chips),
                                    analysis.analyze(c4, chips), l2, l4,
                                    l_full)
        # memory: the capped run's temporaries; the arguments whole
        _, arg_b, _ = _arg_bytes_full(cfg, shape, mesh)
        peak, secs, ops = c4.peak, s2 + s4, c2.ops + c4.ops
        rec["layers_counted"] = [l2, l4]
    else:
        c, arg_b, _, secs = count(cfg, shape, mesh)
        roof = analysis.analyze(c, chips)
        peak, ops = c.peak, c.ops
        rec["layers_counted"] = [l_full]
    mf = analysis.model_flops(cfg, shape)
    rec.update({
        "status": "ok",
        "count_s": secs,
        "local_ops": ops,
        "model_flops_total": mf,
        "model_flops_per_device": mf / chips,
        "roofline": roof.as_dict(),
        "useful_flop_frac": (mf / chips) / max(roof.flops, 1.0),
        "argument_size_in_bytes": int(arg_b),
        "temp_size_in_bytes": int(peak),
        "hbm_per_device_gib": (arg_b + peak) / 2 ** 30,
        "fits_80gb": (arg_b + peak) < analysis.HBM_BYTES,
        "layout": "megatron" if shd.megatron_layout() else "baseline",
    })
    if verbose:
        print(f"OK {arch} {shape_name} {mesh_name}: counted in {secs:.1f}s "
              f"({ops} local ops), hbm/dev={rec['hbm_per_device_gib']:.2f}"
              f"GiB flops/dev={roof.flops:.4g} bytes/dev="
              f"{roof.bytes_accessed:.4g} coll/dev={roof.coll_bytes:.4g} "
              f"{ {k: v for k, v in roof.coll_breakdown.items() if v} } "
              f"t_comp={roof.t_compute:.4g}s t_mem={roof.t_memory:.4g}s "
              f"t_coll={roof.t_collective:.4g}s -> {roof.bottleneck}; "
              f"useful={rec['useful_flop_frac']:.3f}")
    _write(rec, outdir)
    return rec


def _arg_bytes_full(cfg, shape, mesh):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        return build(cfg, shape, mesh)


def _write(rec, outdir):
    os.makedirs(outdir, exist_ok=True)
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json"
    with open(os.path.join(outdir, name), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cap", type=int, default=0,
                    help="count N and N+2 layers a segment and extrapolate "
                    "(0: the full depth)")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    try:
        if args.all:
            fails = []
            for arch in ARCH_IDS:
                for shape in INPUT_SHAPES:
                    for mp in (False, True):
                        try:
                            run_one(arch, shape, mp, args.out, cap=args.cap)
                        except Exception as e:  # noqa: BLE001
                            print(f"FAIL {arch} {shape} mp={mp}: {e!r}")
                            fails.append((arch, shape, mp))
            if fails:
                sys.exit(1)
            return
        run_one(args.arch, args.shape, args.multi_pod, args.out,
                cap=args.cap)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
