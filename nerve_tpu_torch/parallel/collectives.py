"""The collectives of the multi-device paths, on ``torch.distributed``.

They stand in for the JAX package's ``lax.ppermute`` (the halo exchange of
``parallel.spatial``) and ``lax.psum`` (the CBAM pool of a height-sharded
frame, BatchNorm's statistics and the gradients of a data-parallel step).
``exchange_halo`` and ``all_reduce_sum`` are ``torch.autograd.Function``s,
so a loss through a sharded forward has the gradient of the one-device
forward, as ``shard_map`` transposes its collectives.

The transport follows ``dist.get_backend(group)``: on NCCL the tensors move
as they lie on the card; on gloo as host copies (gloo's point-to-point takes
CPU tensors), which serves the CPU and ranks that share one card. Any other
backend raises. Nothing is caught and retried.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist


def _on_host(x: torch.Tensor, group) -> bool:
    """Whether ``x`` crosses ``group`` as a host copy."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        if not x.is_cuda:
            raise ValueError(f"NCCL moves CUDA tensors, not {x.device}")
        return False
    if backend == "gloo":
        return not x.is_cpu
    raise ValueError(f"no transport for backend {backend!r} (nccl or gloo)")


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place (no gradient); returns ``x``."""
    if _on_host(x, group):
        h = x.cpu()
        dist.all_reduce(h, group=group)
        x.copy_(h)
    else:
        dist.all_reduce(x, group=group)
    return x


def broadcast_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of the group's first rank, in place on every rank; returns ``x``."""
    src = dist.get_global_rank(group, 0)
    if _on_host(x, group):
        h = x.detach().cpu()
        dist.broadcast(h, src, group=group)
        x.copy_(h)
    else:
        dist.broadcast(x, src, group=group)
    return x


def all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``x`` (same shape on each), in group rank order, on
    ``x``'s device."""
    n = dist.get_world_size(group)
    src = x.detach().contiguous()
    host = _on_host(src, group)
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return [p.to(x.device) for p in parts] if host else parts


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; its gradient is the sum of the
    gradients over ``group`` (``lax.psum`` and its transpose)."""
    return _AllReduceSum.apply(x, group)


def _neighbours(group) -> Tuple[Optional[int], Optional[int]]:
    """The global ranks before and after this one in ``group`` (None at an
    edge)."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    prev = dist.get_global_rank(group, i - 1) if i > 0 else None
    nxt = dist.get_global_rank(group, i + 1) if i < n - 1 else None
    return prev, nxt


def _swap(up: torch.Tensor, down: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """Send ``up`` to the previous rank and ``down`` to the next; return
    (what the previous rank sent down, what the next rank sent up), zeros
    at an edge."""
    prev, nxt = _neighbours(group)
    host = _on_host(up, group)
    up, down = up.contiguous(), down.contiguous()
    if host:
        up, down = up.cpu(), down.cpu()
    from_prev, from_next = torch.zeros_like(down), torch.zeros_like(up)
    p2p = []
    if prev is not None:
        p2p += [dist.P2POp(dist.isend, up, prev, group),
                dist.P2POp(dist.irecv, from_prev, prev, group)]
    if nxt is not None:
        p2p += [dist.P2POp(dist.isend, down, nxt, group),
                dist.P2POp(dist.irecv, from_next, nxt, group)]
    if p2p:
        for req in dist.batch_isend_irecv(p2p):
            req.wait()
    return from_prev, from_next


class _ExchangeHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo, group):
        ctx.halo, ctx.group = halo, group
        from_prev, from_next = _swap(x[..., :halo, :, :], x[..., -halo:, :, :], group)
        return torch.cat([from_prev.to(x.device), x, from_next.to(x.device)], dim=-3)

    @staticmethod
    def backward(ctx, g):
        h = ctx.halo
        # The top halo's gradient belongs to the previous rank's bottom rows,
        # the bottom halo's to the next rank's top rows.
        from_prev, from_next = _swap(g[..., :h, :, :], g[..., -h:, :, :], ctx.group)
        dx = g[..., h:g.shape[-3] - h, :, :].clone()
        dx[..., :h, :, :] += from_prev.to(g.device)
        dx[..., dx.shape[-3] - h:, :, :] += from_next.to(g.device)
        return dx, None, None


def exchange_halo(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """(..., Hs, W, C) slab → (..., Hs + 2·halo, W, C): the previous rank's
    bottom ``halo`` rows above, the next rank's top rows below, zeros at the
    frame's top and bottom edges (the one-device SAME padding); the JAX
    package's ``_exchange_halo``. ``halo`` ≤ Hs."""
    if not 0 <= halo <= x.shape[-3]:
        raise ValueError(f"halo {halo} outside [0, {x.shape[-3]}] for a slab of "
                         f"{x.shape[-3]} rows")
    if halo == 0:
        return x
    return _ExchangeHalo.apply(x, halo, group)
