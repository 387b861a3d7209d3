"""The scans' shape-only path: on meta tensors or FakeTensors, a loop of
identical steps returns its outputs without stepping.

The scans (``kernels.mamba_scan``'s plain versions, ``models.layers``'
``ssm_scan_ref`` and ``_ssd_scan``) step token by token.  On meta or
fake inputs (the Piper IR's tracing, the cost model's ``analyze_fn``,
the dry run) each step still dispatches its ops, so a 32,768-token
prefill takes 32,768 steps a layer.  Every step has the same shapes, so
whatever a counter sees of such a loop is a polynomial in its sizes: the
number of chunks n and the chunk length q, of degree at most two in each
(a step's slice backward fills a whole chunk, a chunk's a whole
sequence).  ``run`` steps the same function on meta tensors at each
point of the grid {2, 3, 4} per size, under fresh counters of the kinds
the caller has entered, interpolates every count through those points
(exactly, in integers) and charges the active counters what the real
sizes would have charged: FLOPs, bytes accessed, the op histogram.  It
allocates the outputs at their interpolated shapes, holds as many bytes
as the stepping function holds when it returns, and allocates and frees
its transient peak, so a storage counter sees the stepping path's peak.
Under autograd the backward does the same when it runs.

A counter takes part by mixing in ``Charged``.  Nothing changes on CPU
or CUDA tensors.  ``stepping()`` (or ``REPRO_TORCH_STEP_SCANS=1``)
turns the path off, to hold it against the stepping one.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import weakref
from typing import Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten, tree_unflatten

GRID = (2, 3, 4)         # the sizes each probe steps, per size variable
_ACTIVE: list = []       # the entered counters, innermost last
_STEP = [os.environ.get("REPRO_TORCH_STEP_SCANS") == "1"]
_QUIET = [0]
_PLANS: dict = {}
MIN_STEPS = 256          # shorter loops step: the probes would cost more
MEMORY_UNITS = (3, 4)    # the first size's values of the memory probes


class Charged:
    """Mixin of a counter the shape-only path charges.  Entering it
    registers it; ``tally`` returns its additive counts as a flat dict,
    ``charge`` adds such a dict, ``fresh`` makes an empty counter of the
    same kind (the probes run under fresh ones).  A dispatch mode that
    tracks storage sets ``tracks_storage``: the path then allocates what
    the stepping function would hold and its transient peak, and the
    path's allocations come to such a mode as ``allocated(out)``, not as
    counted ops (``is_quiet``)."""

    def __enter__(self):
        out = super().__enter__()
        _ACTIVE.append(self)
        return out

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    tracks_storage = False

    def fresh(self):
        return type(self)()

    def tally(self) -> dict:
        raise NotImplementedError

    def charge(self, delta: dict) -> None:
        raise NotImplementedError


@contextlib.contextmanager
def stepping():
    """Within the body the scans step on meta and fake tensors too."""
    _STEP.append(True)
    try:
        yield
    finally:
        _STEP.pop()


def is_quiet() -> bool:
    """True while the path allocates its outputs: counters track their
    storage and count no op."""
    return _QUIET[0] > 0


@contextlib.contextmanager
def _quiet():
    _QUIET[0] += 1
    try:
        yield
    finally:
        _QUIET[0] -= 1


def applies(*tensors) -> bool:
    """True when every given tensor (None skipped) is a meta tensor or a
    ``FakeTensor`` (the cases in which the kernels' wrappers take their
    plain versions without computing) and stepping is not asked for."""
    if _STEP[-1]:
        return False
    from torch._subclasses.fake_tensor import FakeTensor
    given = [t for t in tensors if t is not None]
    return bool(given) and all(isinstance(t, FakeTensor) or t.device.type == "meta"
                               for t in given)


class Spec(NamedTuple):
    """What ``like`` needs of a tensor: a size maker holds these, not the
    tensors (which a plan would keep alive)."""
    shape: tuple
    dtype: torch.dtype
    requires_grad: bool


def specs(*tensors) -> list:
    return [None if t is None else Spec(tuple(t.shape), t.dtype, t.requires_grad)
            for t in tensors]


def like(t: Spec | None, **dims):
    """A meta tensor like ``t`` (a ``Spec``) with the dims given by index
    (``like(x, d1=S)``) replaced; None stays None."""
    if t is None:
        return None
    shape = list(t.shape)
    for key, size in dims.items():
        shape[int(key[1:])] = size
    return torch.empty(shape, dtype=t.dtype, device="meta").requires_grad_(t.requires_grad)


def _basis(x: int) -> tuple:
    """Lagrange weights at ``x`` of the points GRID (integers)."""
    a = GRID[0]
    return ((x - a - 1) * (x - a - 2) // 2, -(x - a) * (x - a - 2), (x - a) * (x - a - 1) // 2)


def _interpolate(points: dict, at: tuple) -> dict:
    """Each count of ``points`` ({grid point: {key: int}}) at ``at``."""
    weights = [_basis(x) for x in at]
    out: dict = {}
    for point, counts in points.items():
        w = 1
        for i, x in enumerate(point):
            w *= weights[i][GRID.index(x)]
        for key, v in counts.items():
            out[key] = out.get(key, 0) + w * v
    return out


class _Live(TorchDispatchMode):
    """Live and peak bytes of the storages the ops under it allocate."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._storages: dict[int, int] = {}

    def _free(self, key: int, nbytes: int) -> None:
        self._storages.pop(key, None)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st._cdata not in self._storages:
                    self._storages[st._cdata] = st.nbytes()
                    self.live += st.nbytes()
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(st, self._free, st._cdata, st.nbytes())
        return out


def _same(t):
    return t


@contextlib.contextmanager
def _no_saved_tensors_hooks():
    """The saved-tensor hooks in force (an enclosing checkpoint's) lifted
    for the body: hooks, even ones that return what they are given, add
    ops to a backward."""
    ag = torch._C._autograd
    stack = []
    while (top := ag._top_saved_tensors_default_hooks(True)) is not None:
        stack.append(top)
        ag._pop_saved_tensors_default_hooks()
    try:
        yield
    finally:
        for pack, unpack in reversed(stack):
            ag._push_saved_tensors_default_hooks(pack, unpack)


class _Saves:
    """Counts the tensors autograd saves under it, and the bytes of those
    that require grad (a checkpoint's recompute detaches those), and
    keeps the counters' tallies as they stood at the last save (where an
    enclosing checkpoint's recompute may stop)."""

    def __init__(self, counters: list):
        self.counters = counters
        self.count = self.grads = self.nbytes = 0
        self.before: list = [{} for _ in counters]

    def pack(self, t):
        self.count += 1
        if t.requires_grad:
            self.grads += 1
            self.nbytes += t.numel() * t.element_size()
        self.before = [c.tally() for c in self.counters]
        return t


def _tensors(args) -> list:
    return [t for t in tree_flatten(args)[0] if isinstance(t, torch.Tensor)]


class _Out(NamedTuple):
    shape: tuple
    stride: tuple
    dtype: torch.dtype


def _layout(outs) -> tuple:
    """(spec, [an ``_Out`` for each tensor, other leaves as they are]) of
    a function's outputs."""
    flat, spec = tree_flatten(outs)
    return spec, [_Out(tuple(t.shape), tuple(t.stride()), t.dtype)
                  if isinstance(t, torch.Tensor) else t for t in flat]


class _Plan:
    """One function's probes for one signature and one set of counter
    kinds: the forward's counts and output layouts at the grid, the
    backward's for each pattern of output gradients (on first use), and
    memory (on first use, when a counter tracks storage)."""

    def __init__(self, fn: Callable, make: Callable, nvars: int, grad: bool, protos: list):
        self.fn, self.make, self.nvars, self.grad = fn, make, nvars, grad
        self.fresh = [c.fresh for c in protos]
        self.fwd = self._probe(None, itertools.product(GRID, repeat=nvars), self.fresh)
        self.bwd: dict = {}
        self.mem: dict = {}

    def _probe(self, backward, points, fresh) -> dict:
        """{point: counts} of the stepping function (of its backward for
        the output-gradient pattern ``backward``) under fresh counters
        (each count keyed (counter index, key)); memory under "peak",
        "held" or "grad_bytes"; the outputs' layout under "layout"."""
        saved = list(_ACTIVE)
        try:
            # the caller's modes, counters and saved-tensor hooks (an
            # enclosing checkpoint's, which count what is saved) see none
            # of the probes
            with _disable_current_modes(), _no_saved_tensors_hooks(), stepping(), \
                    torch.set_grad_enabled(self.grad):
                _ACTIVE.clear()
                return {point: self._one(point, backward, [f() for f in fresh])
                        for point in points}
        finally:
            _ACTIVE[:] = saved

    def _one(self, point, backward, fresh) -> dict:
        args, kw = self.make(*point)
        live = _Live()
        if backward is None:
            saves = _Saves(fresh)
            with contextlib.ExitStack() as stack:
                for mode in (live, *fresh):
                    stack.enter_context(mode)
                stack.enter_context(torch.autograd.graph.saved_tensors_hooks(saves.pack, _same))
                outs = self.fn(*args, **kw)
            out_bytes = sum(t.untyped_storage().nbytes() for t in _tensors(outs))
            counts = {"peak": live.peak, "held": live.live - out_bytes,
                      "saved": saves.count, "saved_grads": saves.grads,
                      "saved_bytes": saves.nbytes,
                      "layout": _layout(outs)}
        else:
            with live:
                outs = self.fn(*args, **kw)
            roots = [o for o, m in zip(_tensors(outs), backward) if m]
            grads = [torch.empty_like(o) for o in roots]
            wrt = [t for t in _tensors((args, kw)) if t.requires_grad]
            start = live.peak = live.live
            with contextlib.ExitStack() as stack:
                for mode in (live, *fresh):
                    stack.enter_context(mode)
                got = torch.autograd.grad(roots, wrt, grads, allow_unused=True)
            counts = {"peak": live.peak - start,
                      "grad_bytes": sum(g.untyped_storage().nbytes() for g in got
                                        if g is not None)}
        for i, c in enumerate(fresh):
            counts.update({(i, key): v for key, v in c.tally().items() if v})
        if backward is None:
            for i, before in enumerate(saves.before):
                counts.update({("before", i, key): v for key, v in before.items() if v})
        return counts

    def counts(self, backward, at: tuple) -> dict:
        """The counters' counts, and the forward's saved tensors' count and
        bytes, at sizes ``at``, interpolated on the grid."""
        if backward is None:
            points = self.fwd
        else:
            if backward not in self.bwd:
                self.bwd[backward] = self._probe(
                    backward, itertools.product(GRID, repeat=self.nvars), self.fresh)
            points = self.bwd[backward]
        return _interpolate({p: {k: v for k, v in c.items()
                                 if isinstance(k, tuple) or k.startswith("saved")}
                             for p, c in points.items()}, at)

    def memory(self, backward, at: tuple) -> dict:
        """Peak, held and gradient bytes at sizes ``at``: a peak is no
        polynomial (the step at which it falls moves with the sizes), so
        the stepping function runs at this call's other sizes and at
        MEMORY_UNITS of the first, and each number is carried on along
        the line through the two."""
        key = (backward, at[1:])
        if key not in self.mem:
            self.mem[key] = self._probe(backward, [(k, *at[1:]) for k in MEMORY_UNITS], [])
        lo, hi = (self.mem[key][(k, *at[1:])] for k in MEMORY_UNITS)
        span = MEMORY_UNITS[1] - MEMORY_UNITS[0]
        return {k: hi[k] + (at[0] - MEMORY_UNITS[1]) * (hi[k] - lo[k]) // span
                for k in ("peak", "held", "grad_bytes") if k in hi}

    def outputs(self, at: tuple, device):
        """The forward's outputs at sizes ``at`` on ``device``, made under
        the caller's modes (call it ``_quiet``)."""
        spec = self.fwd[(GRID[0],) * self.nvars]["layout"][0]
        layouts = {p: c["layout"][1] for p, c in self.fwd.items()}
        flat = []
        for j, item in enumerate(next(iter(layouts.values()))):
            if not isinstance(item, _Out):
                flat.append(item)
                continue
            rank = len(item.shape)
            dims = _interpolate({p: {**{("shape", k): lay[j].shape[k] for k in range(rank)},
                                     **{("stride", k): lay[j].stride[k] for k in range(rank)}}
                                 for p, lay in layouts.items()}, at)
            shape = tuple(dims.get(("shape", k), 0) for k in range(rank))
            stride = tuple(dims.get(("stride", k), 0) for k in range(rank))
            if min(shape + stride, default=0) < 0:
                raise RuntimeError(f"shape-only {self.fn.__name__}: output {j} interpolates "
                                   f"to shape {shape}, stride {stride}")
            flat.append(torch.empty_strided(shape, stride, dtype=item.dtype, device=device))
        return tree_unflatten(flat, spec)


def _transient(nbytes: int, device) -> None:
    """Allocate ``nbytes`` and free them: a storage counter's peak sees
    them on top of what is live."""
    if nbytes > 0:
        torch.empty((nbytes,), dtype=torch.uint8, device=device)


def _charge(counts: dict, protos: list, part: str = "all") -> None:
    """Charge each counter its counts: "all" of them, those "before" the
    stepping function's last save, or those "after" it."""
    for i, c in enumerate(protos):
        full = {key[1]: v for key, v in counts.items() if isinstance(key, tuple)
                and len(key) == 2 and key[0] == i}
        before = {key[2]: v for key, v in counts.items() if isinstance(key, tuple)
                  and len(key) == 3 and key[1] == i}
        delta = (full if part == "all" else before if part == "before"
                 else {k: v - before.get(k, 0) for k, v in full.items()})
        delta = {k: v for k, v in delta.items() if v}
        if delta:
            c.charge(delta)


class _Call:
    """One call of a function on the shape-only path."""

    def __init__(self, fn, make, at: tuple, key, grad: bool, inputs: list):
        self.fn, self.make, self.at, self.key, self.grad = fn, make, at, key, grad
        # the inputs' layouts only: holding them would keep alive what an
        # enclosing checkpoint frees
        self.inputs = [_Out(tuple(t.shape), tuple(t.stride()), t.dtype) for t in inputs]
        self.device = inputs[0].device

    def _plan(self) -> tuple:
        """(the plan for the entered counters, those counters, whether one
        of them tracks storage)."""
        protos = list(_ACTIVE)
        plan_key = (self.key, self.grad, tuple(type(c) for c in protos))
        if plan_key not in _PLANS:
            _PLANS[plan_key] = _Plan(self.fn, self.make, len(self.at), self.grad, protos)
        return _PLANS[plan_key], protos, any(c.tracks_storage for c in protos)

    def stand_ins(self) -> list:
        """Tensors standing in for what the stepping function saves for
        its backward: as many, as many of them requiring grad, with as
        many bytes (an enclosing checkpoint's recompute detaches those
        that require grad), views over as many bytes as the stepping
        function holds when it returns.  ``_Shaped`` takes them as inputs
        and saves them: only inputs and outputs are saved through the
        saved-tensor hooks, and a checkpoint frees what it saves."""
        plan, _, storage = self._plan()
        c = plan.counts(None, self.at)
        held = plan.memory(None, self.at)["held"] if storage else 0
        with _quiet():
            # a non-leaf requiring grad (the stepping function saves no
            # leaf, and a leaf's accumulator would keep it alive)
            leaf = torch.zeros((), dtype=torch.bfloat16, device=self.device).requires_grad_()
            base = leaf.expand(max(held, 2) // 2).clone()
            grads = [base[:0] for _ in range(c.get("saved_grads", 0))]
            if grads:
                grads[0] = base.as_strided((c["saved_bytes"] // 2,), (0,))
            return grads + [base[:0].detach() for _ in range(c.get("saved", 0) - len(grads))]

    def forward(self, grad: bool = False):
        """The outputs, the counters charged (under autograd only up to the
        stepping function's last save: ``after`` charges the rest)."""
        plan, protos, storage = self._plan()
        _charge(plan.counts(None, self.at), protos, "before" if grad else "all")
        with _quiet():
            outs = plan.outputs(self.at, self.device)
            if storage:
                m = plan.memory(None, self.at)
                out_bytes = sum(t.untyped_storage().nbytes() for t in _tensors(outs))
                _transient(m["peak"] - max(m["held"], 0) - out_bytes, self.device)
        return outs

    def after(self) -> None:
        """Charge the ops the stepping function runs after its last save."""
        plan, protos, _ = self._plan()
        _charge(plan.counts(None, self.at), protos, "after")

    def backward(self, present: tuple, needed: tuple) -> list:
        plan, protos, storage = self._plan()
        _charge(plan.counts(present, self.at), protos)
        with _quiet():
            grads = [torch.empty_strided(t.shape, t.stride, dtype=t.dtype, device=self.device)
                     if need else None for t, need in zip(self.inputs, needed)]
            if storage:
                m = plan.memory(present, self.at)
                _transient(m["peak"] - m["grad_bytes"], self.device)
        return grads


class _Shaped(torch.autograd.Function):
    @staticmethod
    def forward(ctx, call, n_inputs, *tensors):
        ctx.set_materialize_grads(False)
        ctx.call, ctx.n_inputs = call, n_inputs
        ctx.save_for_backward(*tensors[n_inputs:])
        return tuple(_tensors(call.forward(grad=True)))

    @staticmethod
    def backward(ctx, *grads):
        ctx.saved_tensors                 # unpacked, as the stepping backward unpacks its own
        present = tuple(g is not None for g in grads)
        n = ctx.n_inputs
        got = ctx.call.backward(present, ctx.needs_input_grad[2:2 + n])
        return (None, None, *got, *[None] * (len(ctx.needs_input_grad) - 2 - n))


def _signature(args) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.requires_grad) if isinstance(t, torch.Tensor)
                 else t for t in tree_flatten(args)[0])


def run(fn: Callable, args: tuple, kw: dict, make: Callable, at: tuple):
    """``fn(*args, **kw)``, a loop of identical steps, without stepping.
    ``make(*sizes)`` returns (args, kw) of ``fn`` at other sizes (meta
    tensors, see ``like``) and ``at`` are this call's sizes, each at
    least GRID[0].  Plans are cached on ``fn`` and the signature at the
    grid's first point.  Under autograd (grad enabled and an input
    requiring it) the outputs carry a graph whose backward charges what
    the stepping backward would."""
    inputs = _tensors((args, kw))
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
    with _disable_current_modes():
        key = (fn, _signature(make(*(GRID[0],) * len(at))))
    call = _Call(fn, make, tuple(at), key, grad, inputs)
    if not grad:
        return call.forward()
    stand_ins = call.stand_ins()
    flat = _Shaped.apply(call, len(inputs), *inputs, *stand_ins)
    del stand_ins
    call.after()
    flat = iter((flat,) if isinstance(flat, torch.Tensor) else flat)
    spec, layout = call._plan()[0].fwd[(GRID[0],) * len(at)]["layout"]
    return tree_unflatten([next(flat) if isinstance(x, _Out) else x for x in layout], spec)
