"""One rank of the port's multi-rank CPU checks (gloo), spawned by
``tests/test_torch_sharding.py`` with ``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` / ``MASTER_PORT`` set; not a test module.

  python tests/torch_mesh_worker.py <job> <directory>

``<directory>`` holds the inputs the test wrote (``inputs.npz``: the
weights as leaves in ``training.tree.leaves`` order, batches, attention
inputs); rank 0 writes ``<job>.npz`` there. Jobs:

* ``mesh``: on a (world / 4) x 4 ``("data", "model")`` mesh, one sharded
  train step of smoke danube (float32) and its checkpoint (written whole
  by rank 0 into ``<directory>/ckpt``, restored sharded), the sharded
  forward of smoke
  deepseek-v2 (MLA + MoE through ``moe_apply``) in float32 and bf16, one
  decode step of smoke danube over a sequence-sharded cache, and
  ``dist_attention`` over the ``model`` axis.
* ``launch``: ``repro_torch.launch.train --reduced --device cpu
  --model-parallel 2 --steps 3``; its losses.
* ``one``: on a one-rank mesh, ``Model.loss`` and its gradients under a
  ``MeshPolicy`` for each plan family of the test's list.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.bridge import init_params  # noqa: E402
from repro_torch.core.distkv.dist_attention import dist_attention  # noqa
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import init_distributed  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.training import checkpoint, optimizer  # noqa: E402
from repro_torch.training.train_loop import make_train_step  # noqa: E402
from repro_torch.training.tree import leaves, unflatten  # noqa: E402

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def tree_from(inputs, prefix, cfg):
    """The float32 weights saved under ``prefix`` in the structure of the
    port's tree for ``cfg``, each leaf in its dtype there (a bf16 model
    keeps its float32 router)."""
    like = init_params(cfg, seed=0, device="cpu")
    return unflatten(like, [torch.tensor(inputs[f"{prefix}{i}"],
                                         dtype=t.dtype)
                            for i, t in enumerate(leaves(like))])


def job_mesh(inputs, mesh, d):
    out = {}
    # one sharded train step of smoke danube, float32
    cfg = dataclasses.replace(smoke_config("h2o-danube-1.8b"),
                              dtype="float32")
    params = tree_from(inputs, "danube", cfg)
    policy = shd.MeshPolicy(mesh, cfg)
    params = shd.distribute(params, shd.param_specs(params, mesh, cfg), mesh)
    batch = {k: torch.from_numpy(inputs[f"batch_{k}"])
             for k in ("tokens", "labels")}
    batch = shd.distribute(batch, shd.batch_specs(batch, mesh, cfg), mesh)
    step = make_train_step(Model(cfg), optimizer.OptConfig(**OPT), policy)
    params, _, m = step(params, optimizer.init(params), batch)
    out["step_loss"] = m["loss"].numpy()
    out["step_grad_norm"] = m["grad_norm"].numpy()
    for i, t in enumerate(leaves(shd.gather(params))):
        out[f"step_param{i}"] = t.numpy()
    # the sharded tree saved whole (rank 0 writes) and restored sharded
    ckpt = os.path.join(d, "ckpt")
    checkpoint.save(ckpt, 1, {"params": params})
    back = checkpoint.restore(ckpt, 1, {"params": params})
    out["ckpt_same"] = np.array(all(
        a.placements == b.placements and torch.equal(a.to_local(),
                                                     b.to_local())
        for a, b in zip(leaves(back), leaves({"params": params}))))
    # the sharded forward of smoke deepseek-v2 in float32 and bf16
    tokens = torch.from_numpy(inputs["moe_tokens"])
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(smoke_config("deepseek-v2-236b"),
                                  dtype=dtype)
        params = tree_from(inputs, "deepseek", cfg)
        policy = shd.MeshPolicy(mesh, cfg)
        params = shd.distribute(params, shd.param_specs(params, mesh, cfg),
                                mesh)
        tok = shd.distribute({"t": tokens}, shd.batch_specs(
            {"t": tokens}, mesh, cfg), mesh)["t"]
        logits, _ = Model(cfg).forward(params, tok, policy=policy)
        out[f"moe_{dtype}"] = logits.full_tensor().float().numpy()
    # a decode step over a sequence-sharded cache (the DistAttention
    # layout): smoke danube's prefill on one device, its caches laid out
    # by cache_specs, one decode_step under the decode policy
    cfg = dataclasses.replace(smoke_config("h2o-danube-1.8b"),
                              dtype="float32")
    params = tree_from(inputs, "danube", cfg)
    model = Model(cfg)
    prompt = torch.from_numpy(inputs["decode_prompt"])
    b, s = prompt.shape
    _, caches = model.prefill(params, prompt, seq_capacity=64)
    policy = shd.MeshPolicy(mesh, cfg, decode=True)
    caches = shd.distribute(caches, shd.cache_specs(caches, mesh, cfg, b),
                            mesh)
    params = shd.distribute(params, shd.param_specs(params, mesh, cfg), mesh)
    step = shd.distribute(
        {"t": torch.from_numpy(inputs["decode_token"]),
         "p": torch.full((b,), s, dtype=torch.int32)},
        {"t": shd.P(("data",), None), "p": shd.P(("data",))}, mesh)
    logits, _ = model.decode_step(params, step["t"], step["p"], caches,
                                  policy=policy)
    out["decode_logits"] = logits.full_tensor().numpy()
    # DistAttention over the model axis
    q, k, v, lens = (torch.from_numpy(inputs[f"da_{n}"])
                     for n in ("q", "k", "v", "lens"))
    out["dist_attention"] = dist_attention(mesh, q, k, v, lens) \
        .full_tensor().numpy()
    return out


def job_launch(inputs, mesh):
    from repro_torch.launch import train as train_launcher
    res = train_launcher.main(["--reduced", "--device", "cpu",
                               "--model-parallel", "2", "--steps", "3"])
    return {"losses": np.asarray(res["losses"]),
            "grad_norms": np.asarray(res["grad_norms"])}


def job_one(inputs, mesh, d):
    """Loss and gradients of each family under a one-rank MeshPolicy and
    without a policy, from the same weights."""
    out = {}
    for arch in inputs["families"]:
        arch = str(arch)
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        params = init_params(cfg, seed=1, device="cpu")
        batch = {k[len(arch) + 1:]: torch.from_numpy(v)
                 for k, v in inputs.items() if k.startswith(arch + "/")}
        model = Model(cfg)
        for name, policy, ps, bt in (
                ("plain", None, params, batch),
                ("mesh", shd.MeshPolicy(mesh, cfg),
                 shd.distribute(params, shd.param_specs(params, mesh, cfg),
                                mesh),
                 shd.distribute(batch, shd.batch_specs(batch, mesh, cfg),
                                mesh))):
            flat = [p.detach().clone().requires_grad_(True)
                    for p in leaves(ps)]
            kw = {} if policy is None else {"policy": policy}
            scope = policy.scope() if policy else torch.enable_grad()
            with scope:
                loss = model.loss(unflatten(ps, flat), bt, **kw)
                loss.backward()
            loss = loss.detach()
            out[f"{arch}/{name}/loss"] = (
                loss.full_tensor() if hasattr(loss, "full_tensor")
                else loss).numpy()
            for i, p in enumerate(flat):
                g = p.grad
                g = g.full_tensor() if hasattr(g, "full_tensor") else g
                out[f"{arch}/{name}/grad{i}"] = g.numpy()
    return out


def main():
    job, d = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    inputs = dict(np.load(os.path.join(d, "inputs.npz"), allow_pickle=False))
    if job == "launch":
        out = job_launch(inputs, None)
        rank = int(os.environ.get("RANK", 0))
    else:
        rank = init_distributed("cpu")
        world = torch.distributed.get_world_size()
        from torch.distributed.device_mesh import init_device_mesh
        mp = 4 if world % 4 == 0 else 1
        mesh = init_device_mesh("cpu", (world // mp, mp),
                                mesh_dim_names=("data", "model"))
        out = {"mesh": job_mesh, "one": job_one}[job](inputs, mesh, d)
        torch.distributed.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(d, f"{job}.npz"), **out)


if __name__ == "__main__":
    main()
