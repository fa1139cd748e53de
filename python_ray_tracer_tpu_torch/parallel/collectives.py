"""Collectives along one mesh axis, with the gradients of JAX's ``shard_map``.

JAX differentiates a sharded render by transposing ``shard_map``: a value
that is the same on every shard of an axis gets its cotangent once, a use
of a sharded input sums over the shards, and the kernels' per-shard VJPs
see only their own share.  ``torch.distributed.nn``'s collectives sum the
cotangents of every rank instead, so a loss that each sphere rank computes
from the same replicated image would count S times.  These Functions carry
JAX's rule (``render.py:157-166`` of the JAX package) over:

* selectors (``pmin``, ``pmax``) run on detached values and carry no
  gradient;
* :func:`psum_owner` sums values of which one rank holds the real one and
  the rest zeros (the owner-masked sum): its backward hands every rank the
  cotangent unchanged, so it reaches the owner's kernel VJP once;
* :func:`gather_prod` multiplies the shards' shadow products: its backward
  gives each rank the cotangent of its own factor only;
* :func:`vary` marks a replicated ray state as an input of per-shard work:
  its backward sums the shards' cotangents (the transpose of JAX's
  ``pcast(..., to="varying")``);
* :func:`shard_rows` cuts this rank's rows of a replicated table, and its
  backward assembles the full gradient from every shard's rows;
* :func:`gather_rows` and :func:`sum_grads` are the ray axis: the image is
  gathered (each rank's backward keeps its own rows of the cotangent) and
  the parameters' gradients are summed over the ray shards.

With gloo, CUDA tensors go through host memory; an axis of size 1 needs no
collective at all.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Axis

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def _via_host(x: torch.Tensor, axis: Axis) -> bool:
    return x.is_cuda and dist.get_backend(axis.group) == dist.Backend.GLOO


def all_reduce(x: torch.Tensor, axis: Axis, op: str = "sum") -> torch.Tensor:
    """``op`` ("sum", "min" or "max") of ``x`` over the axis; no gradient."""
    x = x.detach()
    if axis.size == 1:
        return x
    host = _via_host(x, axis)
    buf = x.cpu() if host else x.clone()
    dist.all_reduce(buf, op=_OPS[op], group=axis.group)
    return buf.to(x.device) if host else buf


def all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``(size, *x.shape)``: every rank's ``x`` in axis order; no gradient."""
    x = x.detach().contiguous()
    if axis.size == 1:
        return x[None]
    host = _via_host(x, axis)
    src = x.cpu() if host else x
    bufs = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(bufs, src, group=axis.group)
    out = torch.stack(bufs)
    return out.to(x.device) if host else out


def pmin(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return all_reduce(x, axis, "min")


def pmax(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return all_reduce(x, axis, "max")


class _PsumOwner(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Vary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis, "sum"), None


class _GatherProd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        parts = all_gather(x, axis)
        ctx.index = axis.index
        ctx.save_for_backward(parts)
        out = parts[0]
        for j in range(1, axis.size):
            out = out * parts[j]
        return out

    @staticmethod
    def backward(ctx, g):
        (parts,) = ctx.saved_tensors
        for j in range(parts.shape[0]):
            if j != ctx.index:
                g = g * parts[j]
        return g, None


class _ShardRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, start, rows):
        ctx.axis, ctx.start, ctx.shape = axis, start, x.shape
        return x[start : start + rows].clone()

    @staticmethod
    def backward(ctx, g):
        full = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        full[ctx.start : ctx.start + g.shape[0]] = g
        return all_reduce(full, ctx.axis, "sum"), None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.index, ctx.rows = axis.index, x.shape[0]
        return all_gather(x, axis).reshape(-1, *x.shape[1:])

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index * ctx.rows : (ctx.index + 1) * ctx.rows], None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, *xs):
        ctx.axis = axis
        return tuple(x.clone() for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        out = list(gs)
        for dtype in {g.dtype for g in gs}:
            sel = [i for i, g in enumerate(gs) if g.dtype == dtype]
            flat = all_reduce(torch.cat([gs[i].reshape(-1) for i in sel]), ctx.axis, "sum")
            for i, piece in zip(sel, torch.split(flat, [gs[i].numel() for i in sel])):
                out[i] = piece.reshape(gs[i].shape)
        return (None, *out)


def psum_owner(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum over the axis of a value one rank owns (the others pass zeros);
    every rank's cotangent flows back to its own ``x`` unchanged."""
    return _PsumOwner.apply(x, axis) if axis.size > 1 else x


def vary(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` itself; its cotangent is summed over the axis."""
    return _Vary.apply(x, axis) if axis.size > 1 else x


def gather_prod(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The product over the axis of every rank's ``x``, in axis order; the
    cotangent reaching ``x`` is the output's times the other ranks' factors."""
    return _GatherProd.apply(x, axis) if axis.size > 1 else x


def shard_rows(x: torch.Tensor, axis: Axis, rows: int) -> torch.Tensor:
    """This rank's ``rows`` rows of ``x`` (row ``axis.index * rows`` on);
    the gradient of ``x`` is assembled from every rank's rows."""
    if axis.size == 1:
        return x
    return _ShardRows.apply(x, axis, axis.index * rows, rows)


def gather_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Every rank's rows of ``x``, concatenated in axis order; the backward
    keeps this rank's rows of the cotangent."""
    return _GatherRows.apply(x, axis) if axis.size > 1 else x


def sum_grads(tensors: list[torch.Tensor], axis: Axis) -> list[torch.Tensor]:
    """The tensors themselves; their gradients are summed over the axis (one
    collective per dtype)."""
    if axis.size == 1 or not tensors:
        return list(tensors)
    return list(_SumGrads.apply(axis, *tensors))
