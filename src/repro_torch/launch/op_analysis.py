"""Trip-count-aware op analysis of an eager step: the counterpart of
``repro/launch/hlo_analysis.py``.

There is no HLO in the port.  An eager step is the sequence of aten ops
that torch's dispatcher runs, and ``analyze_ops(fn, *args)`` counts
them as they run, under a ``TorchDispatchMode``, on the device the
arguments live on.  On ``meta`` nothing is allocated or computed, so a
full-width step of any arch is priced on a host without a card, as the
reference prices its steps on placeholder devices.

What stands in for the HLO:

* an op is one aten call below autograd, so the backward's ops are
  counted as the forward's are (and a rematerialized forward again);
* the FLOP rules are the reference's: a matmul is 2·prod(out)·prod(
  contracted), an elementwise op (a dtype conversion included) one FLOP
  per output element, a reduction one per input element, data movement
  none; transcendentals (exp, log, tanh, sigmoid, sqrt, ...) are counted
  apart; ``flops_by_dtype`` splits the FLOPs by the dtype they run in, so
  that a compute term can take each dtype's peak;
* bytes are each op's operands plus its outputs, each at numel ×
  itemsize of the tensor the op sees (not of a view's base), and views
  cost nothing: the traffic at an eager op's boundary.  XLA fuses
  elementwise chains, so these bytes run above the reference's fused
  figure; they are not comparable with it;
* a hand-written kernel is one op with the kernel's own work, recorded
  by its entry point in ``kernels/ops.py`` on every route alike
  (``kernel``); whatever implements it (the plain version on the CPU and
  meta, the ctypes launch on CUDA, which never reaches the dispatcher)
  is not counted again;
* collectives record their kind and bytes under the reference's names
  (``collective``, called by ``dist/collectives.py``): the output's
  bytes, an all-reduce counted twice in ``total_collective_bytes``;
* loops: a loop that goes through ``trips`` (independent iterations) or
  ``scan`` (a carried state whose backward runs after the loop) records
  its trip count in ``loop_trips``.  On meta, with a counter active, it
  runs one iteration (``trips``), or the first, one middle and the last
  (``scan``), and multiplies the counts of the repeated one — forward
  and backward — by the trips it stands for.  On the CPU and the card a
  loop runs every iteration; the shortcut exists only where nothing is
  computed.

Scope — what the step's device does: when the step runs on a device,
ops whose tensors all lie on the host (the learning-rate schedule,
AdamW's bias corrections) are not counted, and neither are copies
between the host and the device (the decode weights the host's
simulator draws, which the reference passes as an argument of its
entry computation).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpCost", "COLLECTIVES", "analyze_ops", "active", "kernel", "collective",
           "trips", "scan"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh", "sigmoid",
                   "rsqrt", "sqrt", "pow", "cos", "sin", "erf", "erfc", "erfinv", "silu",
                   "gelu", "softplus", "logaddexp", "log_sigmoid_forward", "_softmax",
                   "_log_softmax", "logsumexp", "logit"}
#: kernels that are elementwise or row-wise softmax without the pointwise tag
_POINTWISE_EXTRA = {"log_sigmoid_forward", "log_sigmoid_backward", "_softmax",
                    "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
                    "silu_backward", "gelu_backward", "sigmoid_backward", "tanh_backward",
                    "threshold_backward", "softplus_backward", "logaddexp"}
#: allocation without traffic, and reads of a host scalar
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "_local_scalar_dense", "lift_fresh", "set_", "resize_", "_unsafe_view",
         "is_same_size", "_has_compatible_shallow_copy_type"}
#: reads only the rows it returns (and its indices)
_GATHERS = {"embedding", "index_select", "gather", "index"}
#: writes only the given values into ``self`` (and reads them, and indices)
_SCATTERS_IN_PLACE = {"index_put_", "index_copy_", "scatter_"}
#: in place, ``self`` overwritten without being read
_OVERWRITE = {"copy_", "fill_", "zero_", "normal_", "uniform_", "random_", "bernoulli_"}
_COPIES = {"_to_copy", "copy_"}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


@dataclass
class OpCost:
    """The counts of one analyzed call, under ``HloCost``'s names;
    ``loop_trips`` (the distinct trip counts of the loops that ran) takes
    the place of ``while_trips``."""

    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    collective_bytes: dict = field(default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    collective_counts: dict = field(default_factory=lambda: {k: 0 for k in COLLECTIVES})
    loop_trips: list = field(default_factory=list)
    #: FLOPs by the dtype they run in ("float32", "bfloat16", "int64", ...)
    flops_by_dtype: dict = field(default_factory=dict)
    #: hand-written kernel calls by kernel name, one per launch
    kernel_calls: dict = field(default_factory=dict)
    #: op name -> [calls, flops, bytes]
    by_op: dict = field(default_factory=dict)
    #: ops whose FLOP formula failed: counted for their bytes only
    unpriced: dict = field(default_factory=dict)
    #: what the analyzed call returned
    output: object = field(default=None, repr=False, compare=False)

    @property
    def total_collective_bytes(self) -> float:
        # all-reduce moves ~2x its payload (reduce-scatter + all-gather phases)
        return sum(b * (2.0 if k == "all-reduce" else 1.0)
                   for k, b in self.collective_bytes.items())

    def add(self, name: str, flops: float, nbytes: float, dtype: str,
            transcendentals: float = 0.0, mult: float = 1.0) -> None:
        self.flops += flops * mult
        self.bytes += nbytes * mult
        self.transcendentals += transcendentals * mult
        if flops:
            self.flops_by_dtype[dtype] = self.flops_by_dtype.get(dtype, 0.0) + flops * mult
        rec = self.by_op.setdefault(name, [0.0, 0.0, 0.0])
        rec[0] += mult
        rec[1] += flops * mult
        rec[2] += nbytes * mult


def _tensors(obj, out: list) -> list:
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _tensors(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _tensors(o, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(name: str, args, out) -> float | None:
    """2·prod(out)·prod(contracted), plus one per output element for the
    added term of addmm/baddbmm/addmv."""
    if name in ("mm", "bmm", "mv", "dot", "vdot"):
        return 2.0 * out.numel() * args[0].shape[-1]
    if name in ("addmm", "baddbmm", "addmv"):
        return 2.0 * out.numel() * args[1].shape[-1] + out.numel()
    return None


def _formula_flops(func, args, kwargs, out) -> float | None:
    """torch's own FLOP formula (convolution, attention), if it has one."""
    from torch.utils.flop_counter import flop_registry

    f = flop_registry.get(func._overloadpacket)
    if f is None:
        return None
    return float(f(*args, **kwargs, out_val=out))


class _Counter(TorchDispatchMode):
    """The dispatch mode behind ``analyze_ops``; ``mult`` scales every
    record (0 suspends counting)."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # torch wraps a mode's __torch_dispatch__ to keep its compiler out,
        # importing torch._dynamo at the first op (seconds, in every fresh
        # process); nothing here is compiled
        return False

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device
        self.cost = OpCost()
        self.mult = 1.0

    @contextlib.contextmanager
    def scaled(self, factor: float):
        old = self.mult
        self.mult = old * factor
        try:
            yield
        finally:
            self.mult = old

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.mult:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        if func.is_view or name in _FREE:
            return
        tin = _tensors(args, _tensors(kwargs, []))
        tout = _tensors(out, [])
        devs = {t.device.type for t in tin + tout}
        if self.device.type != "cpu" and devs <= {"cpu"}:
            return  # host work beside a device step
        if name in _COPIES and len(devs) > 1:
            return  # a copy between the host and the device
        if name in _GATHERS:
            nbytes = sum(_nbytes(t) for t in tin[1:]) + 2 * sum(_nbytes(t) for t in tout)
        elif name in _SCATTERS_IN_PLACE:  # (self, indices..., values)
            nbytes = sum(_nbytes(t) for t in tin[1:]) + _nbytes(tin[-1])
        elif name in _OVERWRITE:
            nbytes = sum(_nbytes(t) for t in tin[1:]) + sum(_nbytes(t) for t in tout)
        else:
            nbytes = sum(_nbytes(t) for t in tin) + sum(_nbytes(t) for t in tout)
        ref = tout[0] if tout else (tin[0] if tin else None)
        if ref is None:
            return
        flops = trans = 0.0
        dtype = ref.dtype
        base = name.rstrip("_")  # an in-place op's out-of-place name
        matmul = _matmul_flops(name, args, ref)
        if matmul is not None:
            flops, dtype = matmul, args[-1].dtype
        elif name in _COPIES:
            src = args[1] if name == "copy_" else args[0]
            if src.dtype != ref.dtype:  # a conversion is elementwise
                flops = float(ref.numel())
        elif name == "clone":
            pass  # data movement (the pointwise tag notwithstanding)
        elif torch.Tag.pointwise in func.tags or base in _POINTWISE_EXTRA:
            flops = float(ref.numel())
            floats = [t for t in tin if t.is_floating_point()]
            dtype = floats[0].dtype if floats else ref.dtype
            if base in _TRANSCENDENTAL:
                trans = flops
        elif torch.Tag.reduction in func.tags:
            flops = float(tin[0].numel())
            dtype = tin[0].dtype
            if base in _TRANSCENDENTAL:
                trans = flops
        else:
            try:
                got = _formula_flops(func, args, kwargs, out)
            except Exception:  # noqa: BLE001 — keep the bytes, name the op
                got = None
                self.cost.unpriced[name] = self.cost.unpriced.get(name, 0) + 1
            if got is not None:
                flops = got
                dtype = tin[0].dtype if tin else dtype
        self.cost.add(name, flops, nbytes, _dtype_name(dtype), trans, self.mult)


_ACTIVE: list = []


def active() -> _Counter | None:
    """The innermost running counter, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _first_device(obj, depth: int = 0):
    if isinstance(obj, torch.Tensor):
        return obj.device
    if depth > 6:
        return None
    if isinstance(obj, torch.nn.Module):
        p = next(obj.parameters(), None)
        return None if p is None else p.device
    if isinstance(obj, dict):
        obj = list(obj.values())
    elif hasattr(obj, "__dataclass_fields__"):
        obj = [getattr(obj, k) for k in obj.__dataclass_fields__]
    if isinstance(obj, (list, tuple)):
        for o in obj:
            d = _first_device(o, depth + 1)
            if d is not None:
                return d
    return None


def analyze_ops(fn: Callable, *args, device=None, **kwargs) -> OpCost:
    """Run ``fn(*args, **kwargs)`` once under a counter and return its
    ``OpCost`` (``output`` holds what ``fn`` returned).  ``device``, the
    device the step runs on, defaults to that of the first tensor of the
    arguments (a module's parameters, a dataclass's fields included)."""
    dev = torch.device(device) if device is not None else \
        _first_device((args, kwargs)) or torch.device("cpu")
    c = _Counter(dev)
    _ACTIVE.append(c)
    try:
        with c:
            c.cost.output = fn(*args, **kwargs)
    finally:
        _ACTIVE.pop()
    return c.cost


@contextlib.contextmanager
def kernel(name: str, work: Callable):
    """Around a hand-written kernel's entry point: record its own work,
    ``work()`` -> (FLOPs, bytes, launches), as one op and count nothing of
    what implements it.  A no-op without a counter."""
    c = active()
    if c is None:
        yield
        return
    if c.mult:
        flops, nbytes, calls = work()
        c.cost.add(name, flops, nbytes, "float32", 0.0, c.mult)
        c.cost.kernel_calls[name] = c.cost.kernel_calls.get(name, 0) + calls * c.mult
    with c.scaled(0):
        yield


@contextlib.contextmanager
def collective(kind: str, in_bytes: int, out_bytes: int):
    """Around a collective: record one ``kind`` (a name of
    ``COLLECTIVES``) with ``out_bytes`` of payload, and its input and
    output as traffic; count nothing of what implements it."""
    c = active()
    if c is None:
        yield
        return
    if c.mult:
        c.cost.collective_bytes[kind] += out_bytes * c.mult
        c.cost.collective_counts[kind] += int(c.mult)
        c.cost.add(kind, 0.0, in_bytes + out_bytes, "float32", 0.0, c.mult)
    with c.scaled(0):
        yield


def _note_trips(c: _Counter, n: int) -> None:
    if n not in c.cost.loop_trips:
        c.cost.loop_trips.append(n)
        c.cost.loop_trips.sort()


def _shortcut(c, like) -> bool:
    return c is not None and like.device.type == "meta"


@contextlib.contextmanager
def trips(n: int, like: torch.Tensor):
    """A loop of ``n`` independent, identical iterations (each its own
    forward and backward): yields how many to run — ``n``, or 1 on meta
    under a counter, whose counts then stand for all ``n``.

        with trips(len(items), x) as run:
            for item in items[:run]: ...
    """
    c = active()
    if c is None:
        yield n
        return
    _note_trips(c, n)
    if not _shortcut(c, like) or n <= 1:
        yield n
        return
    with c.scaled(n):
        yield 1


class _Repeated(torch.autograd.Function):
    """Iteration 1 of a ``scan`` standing for ``reps`` trips.  Its
    forward is counted ``reps`` times and returns the carry and ``reps``
    outputs (unallocated on meta), one per trip, as the loop's trips
    each return their own.  Its backward recomputes the iteration
    uncounted and differentiates it, counted ``reps`` times: the
    gradient of an output that is also carried sums its two parts first,
    as autograd does per trip; then each trip after the first adds its
    gradient of a loop-invariant input into the sum, as autograd's
    accumulation over separate trips does."""

    @staticmethod
    def forward(ctx, step, reps, counter, n_carry, *tensors):
        ctx.step, ctx.reps, ctx.counter, ctx.n_carry = step, reps, counter, n_carry
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*tensors)
        with counter.scaled(reps):
            carry, y = step(1, tuple(tensors[:n_carry]), *tensors[n_carry:])
        ctx.y_in_carry = next((k for k, t in enumerate(carry) if t is y), None)
        return (*carry, *torch.empty((reps,) + tuple(y.shape), dtype=y.dtype,
                                     device=y.device).unbind(0))

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[4:]
        inputs = [t.detach().requires_grad_(nd) for t, nd in zip(ctx.saved_tensors, need)]
        c, n_carry = ctx.counter, ctx.n_carry
        with torch.enable_grad(), c.scaled(0):
            carry, y = ctx.step(1, tuple(inputs[:n_carry]), *inputs[n_carry:])
        g_carry = list(grads[:n_carry])
        gy = next((g for g in grads[n_carry:] if g is not None), None)
        k = ctx.y_in_carry
        if k is not None and gy is not None:
            if g_carry[k] is not None:
                with c.scaled(ctx.reps):
                    gy = g_carry[k] + gy
            g_carry[k], gy = gy, None
        pairs = [(o, g) for o, g in zip(carry, g_carry) if g is not None and o.requires_grad]
        if gy is not None and y.requires_grad:
            pairs.append((y, gy))
        wrt = [i for i, x in enumerate(inputs) if need[i]]
        got = [None] * len(inputs)
        if pairs and wrt:
            with c.scaled(ctx.reps):
                ds = torch.autograd.grad([o for o, _ in pairs], [inputs[i] for i in wrt],
                                         [g for _, g in pairs], allow_unused=True)
            for i, d in zip(wrt, ds):
                got[i] = d
            with c.scaled(ctx.reps - 1):
                for d in got[n_carry:]:
                    if d is not None:
                        torch.add(d, d)
        return (None, None, None, None, *got)


def scan(step: Callable, n: int, carry: tuple, consts: tuple):
    """``for i in range(n): carry, y_i = step(i, carry, *consts)``; returns
    (carry, [y_0, ..., y_{n-1}]).  ``carry`` is a tuple of tensors;
    ``consts`` are the loop-invariant tensors the step reads (slicing
    them by ``i`` inside the step).  Every iteration but the first and
    the last must run the same ops: on meta under a counter the middle
    ones are run once and counted ``n - 2`` times, forward and backward."""
    c = active()
    if c is not None:
        _note_trips(c, n)
    if c is None or n < 4 or not _shortcut(c, consts[0]):
        ys = []
        for i in range(n):
            carry, y = step(i, carry, *consts)
            ys.append(y)
        return carry, ys
    carry, y0 = step(0, carry, *consts)
    n_carry = len(carry)
    out = _Repeated.apply(step, n - 2, c, n_carry, *carry, *consts)
    carry, yl = step(n - 1, tuple(out[:n_carry]), *consts)
    return carry, [y0, *out[n_carry:], yl]
