"""The work of a step, counted op by op: the port's counterpart of the JAX
package's ``launch/hlo_cost.py``.

The reference walks the partitioned HLO of a compiled step.  Eager PyTorch
compiles nothing, so :class:`Cost` is a ``TorchDispatchMode`` that sees
every aten op the counted code runs -- on the card, on the CPU, or on the
``meta`` device, where the ops carry shapes and dtypes and nothing is
computed or allocated, so a full-size model's step is counted in seconds
on any host.  ``torch.utils.checkpoint``'s recomputation runs inside the
backward and is counted where it runs, as the reference counts remat.

* **flops**: the matmul-like ops (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, convolution) by the formulas ``torch.utils.flop_counter``
  registers (2 M N K); 1 per output element for elementwise ops (the
  ``pointwise`` tag, and conversions between dtypes); 4 per output element for
  reductions and scans; softmax as its HLO lowering (two row reductions
  and three elementwise passes).  These are the reference's rates.  Data
  movement (copies, gathers, concatenations, fills) costs none.
* **hbm_bytes**: the inputs plus the outputs of every op that is not a
  view.  This is where the count departs from the reference: XLA fuses
  elementwise chains, and ``hlo_cost`` charges a fusion only its touched
  extents, but eager PyTorch runs each op on its own, so each op's reads
  and writes are real memory traffic.
* **peak_bytes**: the peak of the live bytes the counted code allocated
  (each new storage an op returns, freed when Python frees it; found with
  a finalizer on the storage).  Storages made before counting began do
  not count.
* **collectives**: read from a mesh's :class:`~repro_torch.launch.mesh.
  WireLog` (:meth:`Cost.add_wire`) under the reference's HLO names and
  link factors: a permute moves its buffer once, an all-reduce
  2 (g - 1) / g of it, an all-gather (g - 1) / g of its output, a
  reduce-scatter (g - 1) / g of its input.
* **kernels**: the reference counts a Pallas custom call as zero.  The
  port does not: each hand-written kernel's wrapper, on a CUDA or meta
  tensor under an active :class:`Cost`, records its kernel's operations
  and bytes by the formula the port bounds it with (:func:`kernel`), and
  the kernel's own launch is hidden from the count.  So a step counted on
  the card equals the same step counted on meta, and a step that runs
  the kernels is not charged less for it.  On a CPU tensor the wrapper
  runs the kernel's plain version, whose aten ops are counted.

``by_op`` splits calls, flops and bytes per aten op (and per kernel), so
two counts can be compared op by op.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten

__all__ = ["Cost", "active", "kernel", "hidden", "LINK_KIND"]

aten = torch.ops.aten

# the mesh's op kinds under the reference's HLO collective names
LINK_KIND = {"permute": "collective-permute", "psum": "all-reduce",
             "pmax": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter"}

# ops that move no data: allocations without a write (their storage
# still counts towards the peak), and reshapes that the schema does not
# mark as views
_ALLOCS = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
           aten.new_empty_strided}
_FREE = _ALLOCS | {aten._unsafe_view, aten.lift_fresh_copy,
                   aten._local_scalar_dense, aten.sym_size, aten.sym_numel,
                   aten.sym_stride, aten.sym_storage_offset,
                   aten.is_same_size}
# pointwise-tagged ops that only move data (HLO copies cost no flops)
_MOVES = {aten.clone, aten.copy_, aten.copy, aten.masked_fill,
          aten.masked_fill_, aten.fill_, aten.zero_}
# untagged elementwise ops the reference counts at 1 per element
_ELEMENTWISE = {aten._to_copy, aten.tril, aten.triu, aten.lerp,
                aten.lerp_}
# scans and untagged reductions: 4 per output element, as a reduce
_REDUCE = {aten.cumsum, aten.cumprod, aten.logsumexp, aten.topk,
           aten.aminmax, aten.amax, aten.amin, aten.argmax, aten.argmin}
# softmax and its gradient as their HLO lowering: (elementwise passes per
# element, row reductions, the argument that names the dim)
_SOFTMAX = {aten._softmax: (3, 2, 1), aten._log_softmax: (3, 2, 1),
            aten._softmax_backward_data: (3, 1, 2),
            aten._log_softmax_backward_data: (3, 1, 2)}

_ACTIVE: list["Cost"] = []


def active() -> list:
    """The :class:`Cost` counts now active (innermost last)."""
    return list(_ACTIVE)


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _rule(func):
    """``(kind, data)`` for an op overload: how its flops are counted."""
    packet = func.overloadpacket
    if func.is_view or packet in _FREE:
        return ("free", None)
    if packet in flop_counter.flop_registry:
        return ("matmul", flop_counter.flop_registry[packet])
    if packet in _SOFTMAX:
        return ("softmax", _SOFTMAX[packet])
    if packet in _MOVES:
        return ("move", None)
    tags = func.tags
    if torch.Tag.pointwise in tags or packet in _ELEMENTWISE:
        return ("elementwise", None)
    if torch.Tag.reduction in tags or packet in _REDUCE:
        return ("reduce", None)
    return ("move", None)


@dataclasses.dataclass
class _Op:
    calls: int = 0
    flops: float = 0.0
    bytes: float = 0.0


class Cost(TorchDispatchMode):
    """A count of the work of the code run inside ``with Cost() as c:``
    (module docstring): ``flops``, ``hbm_bytes``, ``collective_bytes`` and
    ``collective_counts`` per kind (``total_collective_bytes`` their sum),
    ``peak_bytes`` and ``by_op``; ``add`` and ``to_dict`` as the
    reference's ``HloCost``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collective_bytes: dict = defaultdict(float)
        self.collective_counts: dict = defaultdict(float)
        self.peak_bytes = 0
        self.by_op: dict = defaultdict(_Op)
        self._live = 0
        self._owned: dict = {}          # id(storage) -> bytes
        self._rules: dict = {}

    # -- the reference's HloCost ---------------------------------------------

    @property
    def total_collective_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))

    def add(self, other: "Cost", k: float = 1.0) -> None:
        """Add ``k`` times ``other``'s work (a loop body counted once and
        run ``k`` times); the peak is the larger of the two, as the body's
        temporaries are freed between trips."""
        self.flops += other.flops * k
        self.hbm_bytes += other.hbm_bytes * k
        for kk, v in other.collective_bytes.items():
            self.collective_bytes[kk] += v * k
        for kk, v in other.collective_counts.items():
            self.collective_counts[kk] += v * k
        for name, op in other.by_op.items():
            mine = self.by_op[name]
            mine.calls += int(op.calls * k)
            mine.flops += op.flops * k
            mine.bytes += op.bytes * k
        self.peak_bytes = max(self.peak_bytes, other.peak_bytes)

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_counts": dict(self.collective_counts),
            "total_collective_bytes": self.total_collective_bytes,
            "peak_bytes": self.peak_bytes,
        }

    def ops(self) -> dict:
        """``{op: (calls, flops, bytes)}``, largest bytes first."""
        return {k: (v.calls, v.flops, v.bytes) for k, v in sorted(
            self.by_op.items(), key=lambda kv: -kv[1].bytes)}

    # -- collectives ----------------------------------------------------------

    def add_wire(self, log) -> None:
        """Add what a mesh's ``WireLog`` recorded: per kind its ops and its
        link bytes (the reference's factors, applied as the mesh logged
        each op with its group extent); a scoped kind (``"model:psum"``)
        counts under its kind."""
        for kind, rec in log.kinds.items():
            name = LINK_KIND[kind.rsplit(":", 1)[-1]]
            self.collective_counts[name] += rec["ops"]
            self.collective_bytes[name] += rec["link"]

    # -- counting -------------------------------------------------------------

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def _free(self, key: int, nbytes: int) -> None:
        if self._owned.pop(key, None) is not None:
            self._live -= nbytes

    def _own(self, outs, inputs=()) -> None:
        """Count the new storages among ``outs`` as allocated."""
        skip = {id(t.untyped_storage()) for t in inputs}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in skip or key in self._owned:
                continue
            nbytes = st.nbytes()
            self._owned[key] = nbytes
            weakref.finalize(st, self._free, key, nbytes)
            self._live += nbytes
        self.peak_bytes = max(self.peak_bytes, self._live)

    def _record(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.hbm_bytes += nbytes
        op = self.by_op[name]
        op.calls += 1
        op.flops += flops
        op.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rule = self._rules.get(func)
        if rule is None:
            rule = self._rules[func] = _rule(func)
        kind, data = rule
        if kind == "free":
            if func.overloadpacket in _ALLOCS:
                self._own(_tensors(out))
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        n_out = sum(t.numel() for t in outs)
        if kind == "matmul":
            flops = float(data(*args, **kwargs, out_val=out))
        elif kind == "elementwise":
            # a copy across devices is no convert: no flops
            same = (func.overloadpacket is aten._to_copy
                    and outs[0].dtype == ins[0].dtype)
            flops = 0.0 if same else float(n_out)
        elif kind == "reduce":
            flops = 4.0 * n_out
        elif kind == "softmax":
            per, rows, dim_arg = data
            t = outs[0]
            width = t.shape[args[dim_arg]] if t.ndim else 1
            flops = float(per * t.numel() + 4 * rows * t.numel()
                          // max(width, 1))
        else:
            flops = 0.0
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self._record(str(func.overloadpacket.__name__), flops, nbytes)
        self._own(outs, ins)
        return out


def kernel(name: str, flops: float, nbytes: float, outputs) -> None:
    """Record one hand-written kernel call into every active count: its
    operations and bytes by its formula, and its outputs as allocated."""
    outs = _tensors(outputs)
    for c in _ACTIVE:
        c._record(name, float(flops), float(nbytes))
        c._own(outs)


def hidden():
    """A context in which no :class:`Cost` sees the ops run (a kernel's
    launch, whose work :func:`kernel` records by formula)."""
    return _disable_current_modes()
