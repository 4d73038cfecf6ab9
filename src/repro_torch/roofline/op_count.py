"""Operation counts of a step run on fake tensors: the port's counterpart of
the reference's ``roofline.hlo_parse``.

The reference compiles a step and reads its HLO text; the port has no
program to read. :func:`analyze` runs the step itself on fake tensors, and
a counting ``TorchDispatchMode`` sums what every aten and ``c10d`` op that
reaches the dispatcher does. The fake tensors are meta tensors: their ops
propagate shapes and dtypes and allocate nothing, and an op whose output
shape depends on values (``nonzero``, ``.item()``) raises, as a jitted
step refuses it. ``FakeTensorMode`` does the same over meta storage, at
several times the dispatch cost of a meta op. The Python loops of the
port run, so there is no trip count to infer: a layer loop, a KV-chunk
loop or a microbatch loop counts each pass, and a product recomputed
under remat counts again, as XLA's scaled counts do.

The keys of the reference's ``analyze`` that carry over, with its
conventions:

* ``flops_scaled``: the products' FLOPs (``torch.utils.flop_counter``'s
  formulas: 2 x M x N x K for a matmul).
* ``traffic_dot_bytes_scaled``: the reference's "matmul boundary plus
  state update plus collective" model of HBM traffic: each product's
  operands and result; each in-place write into a cache or state
  (``index_put_``, ``copy_``, ``scatter_``, ``index_copy_``) as twice the
  bytes written (a read-modify-write of the slice); each row gather
  (``index``, ``embedding``, ``gather``, ``index_select``) as its result
  read and written; and the collectives' bytes. The reference dedups the
  reads of the products of one computation; the port counts every
  product's operands.
* ``traffic_bytes_scaled``: every op's tensor inputs and outputs, views
  and allocations excluded (the all-op upper bound).
* ``collective_bytes`` (per kind, and ``total``) and
  ``collective_counts``: from the ``c10d`` ops' tensors, per device and
  execution: all-reduce, all-gather and broadcast count their result
  bytes (the full gathered tensor for an all-gather), reduce-scatter and
  reduce their operand bytes, a gather what this rank sends. The
  reference has no broadcast, reduce or gather kinds; the port's ZeRO
  step uses them.
* ``traffic_by_opcode``: ``traffic_dot_bytes_scaled`` by op.

Beside them, ``peak_live_bytes``: the most bytes that the live storages
held at once: the arguments' (parameters, optimizer state, caches, the
batch) from the start, and every op's new storage from its creation until
it is freed; ``arg_bytes`` is the arguments' alone. The keys that exist
only in XLA (``while_trip_counts``, ``cpu_bf16_upcast_bytes``, the
``xla_cost_*`` keys) have no counterpart.
"""
from __future__ import annotations

import collections
import functools
import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map_only
from torch.utils.flop_counter import flop_registry

# the c10d ops of the port's collectives (all_reduce, all_gather,
# reduce_scatter_tensor, broadcast, reduce, gather) -> (kind, the argument
# whose tensors carry its bytes)
COLLECTIVES = {
    "allreduce_": ("all-reduce", 0),
    "allgather_": ("all-gather", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "broadcast_": ("broadcast", 0),
    "reduce_": ("reduce", 0),
    "gather_": ("gather", 1),
}
STATE_WRITES = {"index_put_": 2, "copy_": 1, "scatter_": 3, "index_copy_": 3}
ROW_GATHERS = {"index", "embedding", "gather", "index_select"}
ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


def _tensors(x: Any, out: list) -> list:
    """The tensors of a nest of tuples, lists and dicts, in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree, []))


def _key(x: Any) -> Any:
    """A hashable key of an op's arguments: each tensor's shape, strides,
    dtype and device, every other value itself (TypeError: unhashable)."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device)
    if isinstance(x, (tuple, list)):
        return (type(x),) + tuple(_key(y) for y in x)
    if isinstance(x, dict):
        return (dict,) + tuple((k, _key(v)) for k, v in x.items())
    hash(x)
    return (type(x), x)


@functools.lru_cache(maxsize=None)
def _op_info(func) -> tuple:
    """(name, composite, functional) of an op: its packet's name; whether
    it is an aten op with a CompositeImplicitAutograd kernel (taken apart
    before it is counted); whether it is an aten op that neither views nor
    writes in place."""
    aten = func.namespace == "aten"
    composite = aten and torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
    functional = aten and not func.is_view and not func._schema.is_mutable
    return func._overloadpacket.__name__, composite, functional


class OpCounter(TorchDispatchMode):
    """Counts every op that reaches the dispatcher (see the module's
    docstring); composite ops are taken apart first, so a matmul counts as
    the ``mm`` or ``bmm`` it becomes."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.traffic_all = 0.0
        self.traffic_dot = 0.0
        self.by_op: dict = collections.defaultdict(float)
        self.coll_bytes: dict = collections.defaultdict(float)
        self.coll_counts: dict = collections.defaultdict(float)
        self._storages: dict = {}     # a live storage's address -> its weak reference
        self._cache: dict = {}
        self.live = 0
        self.peak = 0

    def hold(self, tree: Any) -> int:
        """Count the storages of ``tree``'s tensors as live (once each,
        until the storage is freed); returns the bytes newly held."""
        new = 0
        for t in _tensors(tree, []):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = weakref.ref(st, functools.partial(self._freed, key, n))
            new += n
        self.live += new
        self.peak = max(self.peak, self.live)
        return new

    def _freed(self, key: int, n: int, _ref) -> None:
        self._storages.pop(key, None)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name, composite, functional = _op_info(func)
        if composite:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = self._run(func, functional, args, kwargs)
        if func.namespace == "c10d":
            if name == "barrier":
                return out
            if name not in COLLECTIVES:  # an uncounted collective would read as free
                raise NotImplementedError(f"no byte rule for the collective c10d.{name}")
            kind, arg = COLLECTIVES[name]
            b = _bytes(args[arg])
            self.coll_bytes[kind] += b
            self.coll_counts[kind] += 1
            self.traffic_dot += b
            return out
        if func.is_view or name in ALLOCATIONS:
            self.hold(out)
            return out
        io = _bytes((args, kwargs)) + (_bytes(out) if functional else 0)
        self.traffic_all += io
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
            self._dot(name, io)
        elif name in STATE_WRITES:
            self._dot(name, 2 * _bytes(args[STATE_WRITES[name]]))
        elif name in ROW_GATHERS:
            self._dot(name, 2 * _bytes(out))
        self.hold(out)
        return out

    def _run(self, func, functional: bool, args, kwargs):
        """``func`` on its (meta) arguments. A functional aten op (no view,
        no in-place write) that was seen before with arguments of the same
        shapes, strides, dtypes and values gives new tensors of the shapes
        it gave then: most meta kernels are Python reference code, and a
        recurrence's time loop repeats a few ops on the same shapes."""
        if not functional:
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(kwargs))
            hit = self._cache.get(key)
        except TypeError:       # an argument that is not hashable
            return func(*args, **kwargs)
        if hit is not None:
            kind, metas = hit
            made = [torch.empty_strided(sh, st, dtype=dt, device=dev) for sh, st, dt, dev in metas]
            return made[0] if kind is None else kind(made)
        out = func(*args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if all(isinstance(t, torch.Tensor) for t in outs):
            self._cache[key] = (type(out) if isinstance(out, (tuple, list)) else None,
                                [(t.shape, t.stride(), t.dtype, t.device) for t in outs])
        return out

    def _dot(self, name: str, b: float) -> None:
        self.traffic_dot += b
        self.by_op[name] += b

    def result(self) -> dict:
        total = sum(self.coll_bytes.values())
        return {
            "flops_scaled": self.flops,
            "traffic_bytes_scaled": self.traffic_all,
            "traffic_dot_bytes_scaled": self.traffic_dot,
            "traffic_by_opcode": dict(self.by_op),
            "collective_bytes": dict(self.coll_bytes) | {"total": total},
            "collective_counts": dict(self.coll_counts),
            "peak_live_bytes": self.peak,
        }


def analyze(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` on meta tensors under an
    :class:`OpCounter`; its counts (see the module's docstring). Tensors
    among the arguments that are not meta tensors are taken as meta copies
    of themselves, so nothing runs for real and nothing ``fn`` writes
    reaches them. The result holds ``out``, what ``fn`` returned (meta
    tensors), beside the counts."""
    args, kwargs = tree_map_only(torch.Tensor, lambda t: t if t.is_meta else t.to("meta"),
                                 (args, kwargs))
    counter = OpCounter()
    arg_bytes = counter.hold((args, kwargs))
    with counter:
        out = fn(*args, **kwargs)
    return counter.result() | {"arg_bytes": arg_bytes, "out": out}
