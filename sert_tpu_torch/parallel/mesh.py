"""The ("data", "model") mesh over torch.distributed ranks, and the
collectives the sharded code runs on it (port of
``sert_tpu/parallel/mesh.py``: ``make_mesh`` :14).

The reference is single-controller: one process sees every device and
``jax.sharding.Mesh`` lays them out. PyTorch runs one process per card, so
the port's mesh is a grid of ranks: rank r sits at data index r // tp and
model index r % tp, the process-major order of the reference's
``global_mesh`` (``sert_tpu/parallel/multihost.py:46``), which keeps a
``model`` group within a node. Each axis of size above one has its own
process group; a collective along an axis of size 1 is the identity and
calls nothing, so a (1, 1) mesh needs no process group at all.

The collectives that gradients pass through follow ONE convention, the
reference's (``sert_tpu/ops/xent.py:736-746``): a rank's loss is its
partial of the global loss (the partials of all ranks sum to it), and the
backward of a sum all-reduce is the sum all-reduce of the incoming
gradients. So a gradient that leaves a rank's graph is that rank's partial,
and a leaf replicated over an axis sums its gradient over that axis
(``parallel/train._finish``). The max all-reduce, the all-gather and the
ring shift carry no gradient.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

WORLD = ("data", "model")     # both axes: every rank of the mesh


def world_size() -> int:
    """Ranks in the default process group; 1 without one."""
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def world_rank() -> int:
    """This process's rank in the default process group; 0 without one."""
    return (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)


def local_device(device=None) -> torch.device:
    """``device`` as a torch.device, or this process's card:
    ``cuda:LOCAL_RANK`` (torchrun's variable; 0 without it)."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


class Mesh:
    """A ``dp`` x ``tp`` grid of ranks over the axes ("data", "model"):
    this rank's coordinates, device, and the process group of each axis
    of size above one (None where the axis has size 1)."""

    def __init__(self, dp: int, tp: int, device: torch.device):
        self.shape = {"data": dp, "model": tp}
        self.device = device
        self.rank = world_rank()
        self.coords = {"data": self.rank // tp, "model": self.rank % tp}
        self._groups = {"data": None, "model": None, WORLD: None}
        if dp * tp > 1:
            # new_group is collective: every rank creates every group, in
            # the same order, members or not.
            for d in range(dp):
                ranks = list(range(d * tp, (d + 1) * tp))
                g = dist.new_group(ranks) if tp > 1 else None
                if d == self.coords["data"]:
                    self._groups["model"] = g
            for m in range(tp):
                ranks = list(range(m, dp * tp, tp))
                g = dist.new_group(ranks) if dp > 1 else None
                if m == self.coords["model"]:
                    self._groups["data"] = g
            self._groups[WORLD] = dist.group.WORLD

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def axis_size(self, axis) -> int:
        if axis == WORLD:
            return self.size
        return self.shape[axis]

    def group(self, axis):
        return self._groups[axis]

    def axis_ranks(self, axis: str) -> Sequence[int]:
        """Global ranks along ``axis`` through this rank, in axis order."""
        dp, tp = self.shape["data"], self.shape["model"]
        if axis == "model":
            d = self.coords["data"]
            return list(range(d * tp, (d + 1) * tp))
        return list(range(self.coords["model"], dp * tp, tp))

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']}"
                f", rank={self.rank}, device={self.device})")


def make_mesh(shape: Tuple[int, int] = (1, 1), device=None) -> Mesh:
    """The ("data", "model") mesh of ``shape`` over the ranks of the
    default process group (one rank without one). ``(-1, m)`` / ``(d, -1)``
    infers one axis from the world size. A mesh larger than the world
    raises ValueError, and so does one that leaves ranks out. ``device``:
    this rank's device (default ``cuda:LOCAL_RANK``; the CPU when the
    caller asks)."""
    n = world_size()
    d, m = (int(s) for s in shape)
    if d == -1 and m == -1:
        raise ValueError("at most one mesh axis may be -1")
    if d == -1:
        d = max(n // m, 1)
    if m == -1:
        m = max(n // d, 1)
    if d < 1 or m < 1:
        raise ValueError(f"mesh axes must be positive, got {shape}")
    if d * m > n:
        raise ValueError(f"mesh {d}x{m} needs {d * m} ranks, have {n}")
    if d * m < n:
        raise ValueError(f"mesh {d}x{m} leaves {n - d * m} of the {n} ranks "
                         "out; the mesh must hold every rank")
    return Mesh(d, m, local_device(device))


# ----------------------------- the collectives ------------------------------

Axis = Union[str, Tuple[str, str]]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh],
                   axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` on every rank of it; differentiable,
    its backward the same sum of the gradients (the module's convention).
    The identity on an axis of size 1."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    return _AllReduceSum.apply(x, mesh.group(axis))


class _GradOnFirst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM,
                        group=ctx.mesh.group(ctx.axis))
        if ctx.mesh.coords[ctx.axis] != 0:
            g.zero_()
        return g, None, None


def grad_on_first(x: torch.Tensor, mesh: Optional[Mesh],
                  axis: str) -> torch.Tensor:
    """``x`` itself, whose gradient becomes the sum over ``axis`` of the
    ranks' gradients on the axis's first rank and zero on the others. For
    a tensor computed alike on every rank of ``axis`` from replicated
    leaves (the window reps that a loss's entity blocks share), whose
    gradient on each rank is that rank's partial: the partials are summed
    here, in their own dtype (fp32), before the backward above rounds them
    to the compute dtype, as the reference's shard_map transpose sums them;
    the mesh's sum of the leaves' gradients (``parallel/train._finish``)
    then adds zeros to the first rank's, exactly. The identity on an axis
    of size 1."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    return _GradOnFirst.apply(x, mesh, axis)


@torch.no_grad()
def all_reduce_max(x: torch.Tensor, mesh: Optional[Mesh],
                   axis: Axis) -> torch.Tensor:
    """The elementwise max of ``x`` over ``axis`` (no gradient)."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x.detach()
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=mesh.group(axis))
    return y


@torch.no_grad()
def all_gather(x: torch.Tensor, mesh: Optional[Mesh],
               axis: Axis) -> torch.Tensor:
    """[S, *x.shape]: every rank's ``x`` along ``axis``, in axis order
    (no gradient)."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x.detach()[None]
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.stack(parts)


@torch.no_grad()
def ring_shift(x: torch.Tensor, mesh: Optional[Mesh],
               axis: str) -> torch.Tensor:
    """One hop of the ring along ``axis``: this rank sends ``x`` to axis
    index i + 1 and returns what index i - 1 sent (the reference's
    ``ppermute`` with perm i -> i + 1; no gradient)."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x.detach()
    ranks = mesh.axis_ranks(axis)
    i, n = mesh.coords[axis], len(ranks)
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, ranks[(i + 1) % n]),
        dist.P2POp(dist.irecv, out, ranks[(i - 1) % n])])
    for r in reqs:
        r.wait()
    return out


def broadcast_object(obj, src: int = 0):
    """``obj`` from rank ``src`` on every rank of the world (pickled; only
    this program's ranks send)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier() -> None:
    """Every rank of the world waits for the others (no-op alone)."""
    if world_size() > 1:
        dist.barrier()
