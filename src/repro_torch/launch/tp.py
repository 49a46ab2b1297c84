"""Tensor-parallel training and prefill over a mesh's ``model`` line: the
port's counterpart of the collectives GSPMD inserts inside a replica.

The reference trains on a ``("node", "fsdp", "model")`` mesh with its
parameters laid out by the sharding rules (``launch/sharding.py``) and
lets GSPMD partition the step.  The port makes the partition explicit.
Each rank of a node holds its ``model`` shard of each leaf (after the
fsdp gather), as :func:`~repro_torch.launch.sharding.node_param_specs`
cuts it, and runs the forward and backward on it; the model functions
take a bound :class:`TP` (``tp=``) and read each leaf's cut from its spec
(:meth:`TP.dim`), never from a flag.  With ``tp=None`` every model
function keeps its one-process path.

Four autograd functions over the rank's ``model`` line, built on
:meth:`Mesh.psum <repro_torch.launch.mesh.Mesh.psum>` and
:meth:`Mesh.all_gather <repro_torch.launch.mesh.Mesh.all_gather>` (the
Megatron regions):

- :meth:`TP.copy_to`: identity forward, ``psum`` backward -- a replicated
  input entering a column-parallel product (each rank's gradient of it is
  partial);
- :meth:`TP.reduce_from`: ``psum`` forward, identity backward -- the
  partial outputs of a row-parallel product (or of a local expert
  combine) summed into a replicated result;
- :meth:`TP.gather_from`: ``all_gather`` along a dim forward, the rank's
  slice backward -- a cut tensor made whole for compute that runs
  replicated along the line;
- :meth:`TP.scatter_to`: the rank's slice forward, ``all_gather``
  backward -- a replicated tensor cut for a row-parallel product.

``gather_from``'s backward keeps the rank's slice of the whole tensor's
gradient.  That is right only because the compute that reads the
gathered tensor runs replicated along the line: every rank then holds
the same whole gradient, and its slice is the gradient of its shard.  A
leaf whose spec names ``model`` but which no layer cuts by hand (norm
scales, mamba2's ``conv_w`` / ``conv_b`` and inner norm) is gathered
this way once a pass (:meth:`TP.bind`), before the forward.  Where the
compute that reads a whole tensor is itself split over the line -- the
k / v heads a rank's own query heads read, a qk-norm scale applied to
the rank's heads -- each rank's gradient of it is partial: the tensor
then enters through ``copy_to`` (its gradient summed), and a gathered
one through ``gather_from(partial=True)``, whose backward is one
``reduce_scatter`` (the partial gradients summed, the rank's slice
kept).

:meth:`TP.vocab_ce` is the vocab-parallel cross-entropy in f32 over
logits whose vocabulary is cut over ``model``: a ``pmax`` of the detached
local row maxima, then one ``psum`` of the local sums of exponentials
and of the masked label logits, stacked (the reference's iota == label
masked sum, ``repro/launch/steps.py: train_loss_fn``).

The model-sharded prefill (``steps.make_prefill_step(tp=)``) runs the
same forward, without a gradient, on a replica's serving shards
(``sharding.param_specs(node_axis=False)``, read through
:meth:`TP.serving`); the model-sharded decode (``steps.make_serve_step(
tp=)``) runs the one-token decode on them and on the rank's shard of
the cache (``sharding.cache_specs``), mamba2's ``conv_w`` and
``conv_b`` kept cut (``bind(keep=)``) for its channel block.

Every op is recorded in the mesh's wire log under the scope ``"model"``
(``"model:psum"``, ``"model:all_gather"``, ``"model:pmax"``).  A dry mesh
(``mesh.dry_mesh``) takes meta tensors and returns meta results of the
live ops' shapes, so the dry run counts the same pass.  Under remat the
recompute in backward issues its block's collectives again, in the
forward's order, on every rank of a line alike.
"""
from __future__ import annotations

import copy

import torch

from .sharding import axis_dim

__all__ = ["TP", "HANDLED", "model_dim"]

AXIS = "model"

# leaves whose model cut the layers follow by hand (column- or
# row-parallel products, the vocab-parallel embedding and head, the
# experts); any other leaf cut over model is gathered before the forward
HANDLED = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                     "in_proj", "out_proj", "embed", "lm_head"})


def model_dim(spec: tuple) -> int | None:
    """The dim of a node's leaf (the node axis dropped) that a node-stacked
    spec cuts over ``model``; None where it is replicated over model."""
    d = axis_dim(spec, AXIS)
    return None if d is None else d - 1


def _log(mesh):
    return mesh.log.scope(AXIS)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with _log(ctx.mesh):
            return ctx.mesh.psum(g, AXIS), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        with _log(mesh):
            return mesh.psum(x, AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _slice(x, dim: int, mesh):
    k = x.shape[dim] // mesh.axis_size(AXIS)
    return x.narrow(dim, mesh.axis_index(AXIS) * k, k).contiguous()


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, partial):
        ctx.dim, ctx.mesh, ctx.partial = dim, mesh, partial
        with _log(mesh):
            return mesh.all_gather(x.contiguous(), AXIS, dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            with _log(ctx.mesh):
                g = ctx.mesh.reduce_scatter(g.contiguous(), AXIS,
                                            dim=ctx.dim)
            return g, None, None, None
        return _slice(g, ctx.dim, ctx.mesh), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _slice(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        with _log(ctx.mesh):
            return ctx.mesh.all_gather(g.contiguous(), AXIS,
                                       dim=ctx.dim), None, None


class TP:
    """A mesh's ``model`` line and the model cut of a node's leaves.

    ``specs`` are :func:`~repro_torch.launch.sharding.node_param_specs`
    (node-stacked, at the global shapes; serving specs through
    :meth:`serving`); ``dims`` maps each leaf name to
    the dim of a node's leaf cut over model (None: replicated over it).
    :meth:`bind` ties the names to one pass's leaf tensors, so the layers
    ask :meth:`dim` of the tensors they are handed."""

    def __init__(self, mesh, specs: dict):
        self.mesh = mesh
        self.size = mesh.axis_size(AXIS)
        self.dims = {k: model_dim(s) for k, s in specs.items()}
        self._ids: dict = {}

    @classmethod
    def serving(cls, mesh, specs: dict) -> "TP":
        """A TP over a replica's serving specs
        (``sharding.param_specs(node_axis=False)``, at the global shapes):
        specs with no node axis, which :func:`model_dim` would read one
        dim off, so each is given a replicated leading dim first."""
        return cls(mesh, {k: (None,) + tuple(s) for k, s in specs.items()})

    @property
    def rank(self) -> int:
        """This rank's model coordinate (a live or dry mesh's)."""
        return self.mesh.axis_index(AXIS)

    # -- binding --------------------------------------------------------------

    def bind(self, leaves: dict, keep: tuple = ()) -> tuple["TP", dict]:
        """(this TP bound to ``leaves`` -- a node's ``{name: tensor}`` model
        shards, at its names -- and the leaves the forward reads): a leaf
        cut over model that no layer cuts by hand (its name's last part
        not in :data:`HANDLED` nor in ``keep``, the leaves a pass cuts by
        hand beside them) is gathered whole through :meth:`gather_from`;
        the others are passed as they are."""
        bound = copy.copy(self)
        bound._ids = {}
        view = {}
        handled = HANDLED | set(keep)
        for k, v in leaves.items():
            d = self.dims[k]
            if d is not None and k.rsplit(".", 1)[-1] not in handled:
                v = self.gather_from(v, d)
                d = None
            bound._ids[id(v)] = d
            view[k] = v
        return bound, view

    def dim(self, t: torch.Tensor) -> int | None:
        """The dim of the bound leaf ``t`` cut over model (None: whole)."""
        return self._ids[id(t)]

    # -- the four regions -----------------------------------------------------

    def copy_to(self, x):
        return _CopyTo.apply(x, self.mesh)

    def reduce_from(self, x):
        return _ReduceFrom.apply(x, self.mesh)

    def gather_from(self, x, dim: int = -1, partial: bool = False):
        """``partial``: the compute that reads the whole tensor is split
        over the line, so the backward sums the ranks' gradients before
        keeping the slice (a ``reduce_scatter``)."""
        return _GatherFrom.apply(x, dim % x.ndim, self.mesh, partial)

    def scatter_to(self, x, dim: int = -1):
        return _ScatterTo.apply(x, dim % x.ndim, self.mesh)

    # -- products -------------------------------------------------------------

    def columns(self, x, ws, dt) -> list:
        """``x @ w`` for each leaf of ``ws`` (2-D, ``(in, out)``) on one
        replicated input: ``[(y, cut)]``, ``cut`` where ``w``'s output dim
        is cut over model (column-parallel: y holds the rank's columns).
        The cut products share one :meth:`copy_to` of ``x``."""
        cuts = [self.dim(w) == w.ndim - 1 for w in ws]
        xc = self.copy_to(x) if any(cuts) else x
        return [((xc if c else x) @ w.to(dt), c) for w, c in zip(ws, cuts)]

    def linear(self, x, w, dt, x_cut: bool = False):
        """``x @ w`` by the model cut of the leaf ``w`` (``(in, out)``):
        ``(y, y_cut)``.  ``x_cut``: x holds the rank's block of its last
        dim.  Input dim cut (row-parallel): x scattered unless cut, the
        partial products summed by :meth:`reduce_from`; output dim cut
        (column-parallel): x gathered if cut, entering by
        :meth:`copy_to`, y the rank's columns; uncut: x gathered if cut."""
        d = self.dim(w)
        if d == w.ndim - 2:
            if not x_cut:
                x = self.scatter_to(x, -1)
            return self.reduce_from(x @ w.to(dt)), False
        if x_cut:
            x = self.gather_from(x, -1)
        if d == w.ndim - 1:
            return self.copy_to(x) @ w.to(dt), True
        return x @ w.to(dt), False

    def whole(self, y, cut: bool, partial: bool = False):
        """``y`` gathered along its last dim where ``cut`` (``partial``:
        read by compute split over the line, :meth:`gather_from`)."""
        return self.gather_from(y, -1, partial) if cut else y

    # -- the loss -------------------------------------------------------------

    def vocab_offset(self, local_vocab: int) -> int:
        return self.rank * local_vocab

    def vocab_ce(self, logits, labels):
        """Mean next-token CE in f32 of ``logits`` (..., V / M), the rank's
        block of the vocabulary, against ``labels`` (...) in the whole
        vocabulary: the reference's f32 log-sum-exp with a detached max,
        its label logit the masked sum over the rank's columns."""
        lo = logits.float()
        V = lo.shape[-1]
        with _log(self.mesh):
            mx = self.mesh.pmax(lo.amax(-1, keepdim=True).detach(), AXIS)
        col = torch.arange(V, device=lo.device) + self.vocab_offset(V)
        sums = self.reduce_from(torch.stack([
            torch.exp(lo - mx).sum(-1),
            torch.where(col == labels[..., None], lo, 0.0).sum(-1)], -1))
        lse = mx.squeeze(-1) + torch.log(sums[..., 0])
        return (lse - sums[..., 1]).mean()
