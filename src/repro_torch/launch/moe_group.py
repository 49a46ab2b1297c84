"""The moe family's capacity routing made global over a node's fsdp ranks.

The reference trains with its node's batch rows split over fsdp
(``sharding.batch_spec``) and lets GSPMD keep the capacity dispatch
global: the capacity comes from the whole routing group's assignments,
the stable sort orders every token of the group, and the Switch aux
loss's means run over every token.  A routing group is one micro-batch
of the node's rows (the node's whole batch without micro-batches).  On
the port's mesh a rank holds the contiguous block of ``R = B / F`` rows
of its node's batch; where a group is larger than a rank's rows, it
spans ``G = mb / R`` consecutive ranks of the fsdp line, and a
:class:`MoeGroup` gives ``models/moe.py: _moe_capacity`` the
collectives that make its routing the group's
(``launch.train.routing_group`` says when):

- :meth:`MoeGroup.counts`: one ``all_gather`` of each rank's (E,) int64
  assignment counts; an exclusive prefix over the group's lower ranks
  is each expert's offset, so a rank's assignment to e takes the global
  position ``offset_e + local position`` and ``position < capacity``
  keeps the reference's set; the group's sum gives the aux loss's
  density;
- :meth:`MoeGroup.sum`: the group's sum of a rank's (E,) probability
  sums, one ``psum`` whose backward is a ``psum`` too -- its true
  adjoint.  Each rank's loss carries the group's aux term, so the fsdp
  mean of the ranks' gradients needs every rank's probabilities to get
  the gradient of all G copies; an identity backward (``TP.reduce_from``)
  would give 1/G of it;
- :meth:`MoeGroup.scatter` / :meth:`MoeGroup.gather`: the expert compute
  split over the group.  Each rank holds its kept rows at their group
  slots of an (E, W, d) buffer (W the capacity padded to a multiple of
  G), zeros elsewhere; one ``reduce_scatter`` along the slot dim hands
  each rank its W / G slots of every expert, summed, the rank runs the
  experts on them, and one ``all_gather`` brings every slot's output
  back.  Where F / G groups run side by side on the fsdp line, the
  ranks' buffers are stacked group by group along the slot dim (zeros
  for the other groups), so one reduce-scatter and one all-gather over
  the whole line serve all of them.  Their natural adjoints (an
  all-gather, a reduce-scatter) give the expert weights the gradient
  the fsdp mean expects.

Each op runs on the rank's own fsdp line and is recorded in the mesh's
wire log under the scope ``"moe"``.  A dry mesh (``mesh.dry_mesh``)
takes meta tensors, so the dry run counts the same ops.  Under remat the
recompute issues the layer's ops again, in the forward's order, on
every rank of a line alike.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["MoeGroup", "AXIS", "SCOPE"]

AXIS = "fsdp"
SCOPE = "moe"


def _log(mesh):
    return mesh.log.scope(SCOPE)


class _Sum(torch.autograd.Function):
    """``psum`` forward and backward (the all-reduce's adjoint)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        with _log(mesh):
            return mesh.psum(x, AXIS)

    @staticmethod
    def backward(ctx, g):
        with _log(ctx.mesh):
            return ctx.mesh.psum(g.contiguous(), AXIS), None


class _ReduceScatter(torch.autograd.Function):
    """``reduce_scatter`` along ``dim`` forward, ``all_gather`` backward."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        with _log(mesh):
            return mesh.reduce_scatter(x, AXIS, dim=dim)

    @staticmethod
    def backward(ctx, g):
        with _log(ctx.mesh):
            return ctx.mesh.all_gather(g.contiguous(), AXIS,
                                       dim=ctx.dim), None, None


class _AllGather(torch.autograd.Function):
    """``all_gather`` along ``dim`` forward, ``reduce_scatter`` backward."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        with _log(mesh):
            return mesh.all_gather(x.contiguous(), AXIS, dim=dim)

    @staticmethod
    def backward(ctx, g):
        with _log(ctx.mesh):
            return ctx.mesh.reduce_scatter(g.contiguous(), AXIS,
                                           dim=ctx.dim), None, None


class MoeGroup:
    """A rank's moe routing group: ``size`` (G) consecutive ranks of its
    fsdp line of F, G dividing F; the rank is share ``index`` of group
    ``group`` of the line's ``F / G``."""

    def __init__(self, mesh, size: int):
        fs = mesh.axis_size(AXIS)
        if size < 2 or fs % size:
            raise ValueError(f"a routing group of {size} ranks on an fsdp "
                             f"line of {fs}")
        self.mesh = mesh
        self.size = size
        self.groups = fs // size

    @property
    def group(self) -> int:
        return self.mesh.axis_index(AXIS) // self.size

    @property
    def index(self) -> int:
        return self.mesh.axis_index(AXIS) % self.size

    def counts(self, c: torch.Tensor) -> tuple:
        """(offset, total) of the rank's (E,) int64 counts ``c``: the
        counts of the group's lower ranks summed, and the group's."""
        with _log(self.mesh):
            every = self.mesh.all_gather(c.reshape(1, -1), AXIS, dim=0)
        mine = every[self.group * self.size:(self.group + 1) * self.size]
        return mine[:self.index].sum(0), mine.sum(0)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The group's sum of the ranks' (E,) ``x``, differentiable (its
        gradient the sum of the ranks' gradients)."""
        g = self.group
        stacked = F.pad(x.reshape(1, -1), (0, 0, g, self.groups - g - 1))
        return _Sum.apply(stacked, self.mesh)[g]

    def scatter(self, slots: torch.Tensor) -> torch.Tensor:
        """The rank's (E', W, d) group slots (its own kept rows, zeros
        elsewhere) -> its (E', W / G, d) share of them, summed over the
        group."""
        W = slots.shape[1]
        g = self.group
        stacked = F.pad(slots, (0, 0, g * W, (self.groups - g - 1) * W))
        return _ReduceScatter.apply(stacked, 1, self.mesh)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """The ranks' (E', W / G, d) outputs -> the group's (E', W, d)."""
        W = y.shape[1] * self.size
        full = _AllGather.apply(y, 1, self.mesh)
        return full[:, self.group * W:(self.group + 1) * W]
