"""Collectives over the dimensions of a DeviceMesh, for code inside
``local_map`` (the port's ``shard_map`` bodies), each with the backward
its JAX counterpart has there.

They are ``torch.distributed._functional_collectives`` calls, so a
``TorchDispatchMode`` (the dry-run's counter, ``CommDebugMode``) sees
every one, and they run on the fake process group of the dry-run. Each
takes one mesh dimension name or a tuple of them (major first, as a
``PartitionSpec`` entry names them).
"""

from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol


def _dims(dims):
    return (dims,) if isinstance(dims, str) else tuple(dims)


def _all_reduce(x, op: str, mesh, dims):
    for name in _dims(dims):
        if mesh.size(mesh.mesh_dim_names.index(name)) > 1:
            x = funcol.wait_tensor(funcol.all_reduce(
                x.contiguous(), op, mesh.get_group(name)))
    return x


class _PSum(torch.autograd.Function):
    """``lax.psum`` into a value every rank of the dimensions holds: the
    sum forward, the cotangent passed through backward (each rank's
    share of the sum receives the replicated output's gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        return _all_reduce(x, "sum", mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherScatter(torch.autograd.Function):
    """``lax.all_gather(tiled=True)`` along ``dim``: the gather forward, the
    reduce-scatter of the gradient backward (an FSDP weight gather)."""

    @staticmethod
    def forward(ctx, x, mesh, dims, dim):
        ctx.mesh, ctx.dims, ctx.dim = mesh, dims, dim
        for name in reversed(_dims(dims)):  # minor first
            n = mesh.size(mesh.mesh_dim_names.index(name))
            if n > 1:
                x = funcol.wait_tensor(funcol.all_gather_tensor(
                    x.contiguous(), dim, mesh.get_group(name)))
        return x

    @staticmethod
    def backward(ctx, g):
        for name in _dims(ctx.dims):  # major first
            n = ctx.mesh.size(ctx.mesh.mesh_dim_names.index(name))
            if n > 1:
                g = funcol.wait_tensor(funcol.reduce_scatter_tensor(
                    g.contiguous(), "sum", ctx.dim,
                    ctx.mesh.get_group(name)))
        return g, None, None, None


def psum(x, mesh, dims):
    """Sum over the ranks of ``dims``; the gradient passes through."""
    return _PSum.apply(x, mesh, dims)


def pmax(x, mesh, dims):
    """Maximum over the ranks of ``dims`` (no gradient: the log-sum-exp
    merge's shift)."""
    return _all_reduce(x.detach(), "max", mesh, dims)


def all_gather(x, mesh, dims, dim: int):
    """Concatenate the ranks' ``x`` along ``dim``; reduce-scatter
    backward."""
    return _GatherScatter.apply(x, mesh, dims, dim)
