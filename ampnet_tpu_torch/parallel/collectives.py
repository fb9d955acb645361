"""The collectives of the parallel paths, over a ``Mesh`` axis's group.

JAX gets every collective's transpose from ``shard_map``. Here the two
that carry gradients are autograd functions written out:

  * ``all_gather_rows`` — all-gather along the rows; backward the
    reduce-scatter of the gradient (sum);
  * ``halo_exchange``'s ``ring_exchange`` — one point-to-point exchange per
    live ring offset (rank i sends to i+o, receives from i-o); backward the
    reverse exchange.

``all_reduce_`` (sum, in place, no gradient) serves the batch statistics,
the document frequencies, the metrics and the parameter gradients.
``megatron_all_reduce`` is the head-parallel pair: all-reduce forward,
identity backward (``parallel/head_parallel.py``).

Gloo and CUDA tensors: gloo takes CUDA tensors only for the collectives in
``GLOO_CUDA`` (found on the card by ``scripts/torch_gloo_cuda_probe.py``);
every other collective of a gloo group on CUDA tensors (the point-to-point
exchange) is staged explicitly through host memory (copy to the CPU, the
collective, copy back), and ``Mesh.staged`` counts each staged call by
name. NCCL never stages; an axis of size 1 exchanges nothing.

Bytes: every collective adds to ``Mesh.moved``, under the names below,
the bytes this rank receives from its peers: the exchange's received
rows, the all-gather's other ranks' blocks, the reduce-scatter's other
ranks' contributions to its rows, and for an all-reduce the payload from
each other rank (what a rank needs, whatever the backend's algorithm).
A staged call counts its payload once, not its copies through the host.
The exchange counts its receive buffers, which the caller's ``sizes``
shape: the count shows how many exchanges ran and their row width, not
that the plan's sizes are right.

Timing: while ``Mesh.spans`` is a dict, each collective synchronizes the
rank's device before and after itself and adds its seconds under its name
('halo_exchange', 'halo_exchange_bwd', 'all_gather', 'reduce_scatter',
'grad_all_reduce', 'all_reduce'): the time this rank spends in it, the wait
for its peers included. Off (None, the default) it adds nothing.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from ampnet_tpu_torch.parallel.mesh import Mesh

# the collectives gloo runs on CUDA tensors itself, as
# scripts/torch_gloo_cuda_probe.py found them on an H100 (torch 2.11.0+cu128):
# all_reduce, broadcast, all_gather(_into_tensor), reduce_scatter_tensor (and
# all_to_all_single, which the port does not call) take CUDA tensors; its
# point-to-point send/recv does not ("writev ... Bad address"), so the halo
# exchange is staged through host memory on a gloo group
GLOO_CUDA = frozenset({"all_reduce", "broadcast", "all_gather", "reduce_scatter"})


def _staged(mesh: Mesh, name: str, t: torch.Tensor) -> bool:
    if mesh.backend != "gloo" or not t.is_cuda or name in GLOO_CUDA:
        return False
    mesh.staged[name] = mesh.staged.get(name, 0) + 1
    return True


def _count(mesh: Mesh, name: str, nbytes: int) -> None:
    mesh.moved[name] = mesh.moved.get(name, 0) + int(nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@contextmanager
def _span(mesh: Mesh, name: str):
    if mesh.spans is None:
        yield
        return
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    yield
    if cuda:
        torch.cuda.synchronize(mesh.device)
    mesh.spans[name] = mesh.spans.get(name, 0.0) + time.perf_counter() - t0


def _all_reduce(t: torch.Tensor, mesh: Mesh, axis, name: str = "all_reduce") -> None:
    for a in ((axis,) if isinstance(axis, str) else axis):
        group = mesh.groups.get(a)
        if group is None:
            continue
        _count(mesh, name, (mesh.size(a) - 1) * _nbytes(t))
        if _staged(mesh, "all_reduce", t):
            host = t.cpu()
            dist.all_reduce(host, group=group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=group)


def all_reduce_(t: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """Sum ``t`` in place over ``axis`` (a name, or a tuple of names: one
    after the other); returns t. No gradient."""
    with _span(mesh, "all_reduce"):
        _all_reduce(t, mesh, axis)
    return t


def all_reduce(t: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """The sum of ``t`` over ``axis``, a new tensor (no gradient)."""
    return all_reduce_(t.detach().clone(), mesh, axis)


def _all_gather(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    n = mesh.size(axis)
    t = t.contiguous()
    _count(mesh, "all_gather", (n - 1) * _nbytes(t))
    if _staged(mesh, "all_gather", t):
        host = t.cpu()
        out = torch.empty((n * host.shape[0],) + tuple(host.shape[1:]), dtype=host.dtype)
        dist.all_gather_into_tensor(out, host, group=mesh.groups[axis])
        return out.to(t.device)
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=mesh.groups[axis])
    return out


def _reduce_scatter(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    n = mesh.size(axis)
    t = t.contiguous()
    rows = t.shape[0] // n
    _count(mesh, "reduce_scatter", (n - 1) * _nbytes(t) // n)
    if _staged(mesh, "reduce_scatter", t):
        host = t.cpu()
        out = torch.empty((rows,) + tuple(host.shape[1:]), dtype=host.dtype)
        dist.reduce_scatter_tensor(out, host, group=mesh.groups[axis])
        return out.to(t.device)
    out = torch.empty((rows,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, t, group=mesh.groups[axis])
    return out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        with _span(mesh, "all_gather"):
            return _all_gather(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        with _span(ctx.mesh, "reduce_scatter"):
            return _reduce_scatter(g, ctx.mesh, ctx.axis), None, None


def all_gather_rows(t: torch.Tensor, mesh: Mesh, axis: str = "graph") -> torch.Tensor:
    """[N, ...] on each rank of ``axis`` -> [P*N, ...], index-major (the
    JAX package's ``all_gather(..., tiled=True)``); its backward
    reduce-scatters the gradient, so each rank gets the sum of every rank's
    gradient of its own rows."""
    if mesh.groups.get(axis) is None:
        return t
    return _AllGatherRows.apply(t, mesh, axis)


def _p2p(mesh: Mesh, sends: Sequence[Tuple[torch.Tensor, int]],
         recvs: Sequence[Tuple[torch.Tensor, int]]) -> None:
    """One batch of point-to-point transfers: each (tensor, global rank) of
    ``sends`` to that rank, each of ``recvs`` from it, all waited for."""
    ops = [dist.P2POp(dist.isend, t, peer) for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, t, peer) for t, peer in recvs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()


def _ring(mesh: Mesh, blocks: List[torch.Tensor], offsets: Sequence[int], sizes: Sequence[int],
          axis: str, sign: int) -> List[torch.Tensor]:
    """Send block j to the rank ``sign * offsets[j]`` along the ring of
    ``axis`` and receive ``sizes[j]`` rows from the rank as far the other
    way."""
    p, i = mesh.size(axis), mesh.index(axis)
    members = mesh.ranks[axis]
    ref = blocks[0]
    staged = _staged(mesh, "send_recv", ref)
    dev = torch.device("cpu") if staged else ref.device
    sends = [(b.contiguous().to(dev), members[(i + sign * o) % p])
             for b, o in zip(blocks, offsets)]
    recvs = [(torch.empty((h,) + tuple(ref.shape[1:]), dtype=ref.dtype, device=dev),
              members[(i - sign * o) % p]) for h, o in zip(sizes, offsets)]
    _count(mesh, "halo_exchange" if sign > 0 else "halo_exchange_bwd",
           sum(_nbytes(t) for t, _ in recvs))
    _p2p(mesh, sends, recvs)
    return [t.to(ref.device) for t, _ in recvs]


def ring_exchange_rows(buf: torch.Tensor, mesh: Mesh, offsets: Sequence[int],
                       sizes: Sequence[int], axis: str = "graph",
                       reverse: bool = False) -> torch.Tensor:
    """``ring_exchange`` without autograd: block j of ``buf`` to the rank
    ``offsets[j]`` ahead, the block from as far behind in its place;
    ``reverse``, its backward (each block back to the rank it came from)."""
    blocks = list(torch.split(buf, list(sizes)))
    with _span(mesh, "halo_exchange_bwd" if reverse else "halo_exchange"):
        return torch.cat(_ring(mesh, blocks, offsets, sizes, axis, -1 if reverse else +1))


class _RingExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, mesh, offsets, sizes, axis):
        ctx.mesh, ctx.offsets, ctx.sizes, ctx.axis = mesh, offsets, sizes, axis
        return ring_exchange_rows(buf, mesh, offsets, sizes, axis)

    @staticmethod
    def backward(ctx, g):
        return (ring_exchange_rows(g, ctx.mesh, ctx.offsets, ctx.sizes, ctx.axis, reverse=True),
                None, None, None, None)


def ring_exchange(buf: torch.Tensor, mesh: Mesh, offsets: Sequence[int],
                  sizes: Sequence[int], axis: str = "graph") -> torch.Tensor:
    """``buf`` [sum(sizes), ...], offset-major blocks: block j goes to the
    rank ``offsets[j]`` ahead on ``axis``'s ring, and the block of as many
    rows from the rank as far behind comes back in its place. Backward: the
    reverse exchange of the gradient."""
    if not offsets:
        return buf[:0]
    return _RingExchange.apply(buf, mesh, tuple(offsets), tuple(sizes), axis)


class _MegatronAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        return all_reduce_(t.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _MegatronCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.mesh, ctx.axis), None, None


def megatron_all_reduce(t: torch.Tensor, mesh: Mesh, axis: str = "heads") -> torch.Tensor:
    """Sum of the ranks' partial results over ``axis``; the gradient passes
    unchanged (every rank already holds the whole upstream gradient).
    ``torch.distributed.nn.functional.all_reduce`` would all-reduce it too
    and make it ``axis`` times too large."""
    if mesh.groups.get(axis) is None:
        return t
    return _MegatronAllReduce.apply(t, mesh, axis)


def megatron_copy(t: torch.Tensor, mesh: Mesh, axis: str = "heads") -> torch.Tensor:
    """The entry of a head-parallel region: identity forward, all-reduce of
    the gradient backward (each rank's heads give part of it)."""
    if mesh.groups.get(axis) is None:
        return t
    return _MegatronCopy.apply(t, mesh, axis)


def all_reduce_grads(params, mesh: Mesh, axis, scale: float = 1.0) -> None:
    """Sum the parameters' gradients over ``axis`` in one flat all-reduce,
    times ``scale``; a parameter without a gradient (not reached by the
    loss) takes part as zeros, so every rank sends the same shapes."""
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    with _span(mesh, "grad_all_reduce"):
        _all_reduce(flat, mesh, axis, "grad_all_reduce")
    if scale != 1.0:
        flat.mul_(scale)
    start = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[start:start + n].view_as(p.grad))
        start += n
