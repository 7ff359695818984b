"""Data-dependent control flow on the device: the port's lax.while_loop
and lax.cond.

The JAX package's compiled programs loop and branch on device data: every
Gauss-Newton phase is a `lax.while_loop` that stops when the solve
converges, and the tracker's retry ladder, keyframe snapshot and eviction
sweep run under `lax.cond`.  `while_loop` and `cond` here keep those
semantics on every route:

* Under a capture made with `graph_capture` (CUDA), `while_loop` is one
  WHILE node of the CUDA graph and `cond` two IF nodes (the taken branch
  and the other), built by csrc/graph_cond.cu: a replay runs the rounds
  and the branch that the device data pick, and the host reads nothing.
* Eagerly on CUDA nothing may be read back, so `while_loop` runs to its
  cap with the state of a finished problem frozen, and `cond` computes
  both branches and selects (the masked route).
* On the CPU the same loop stops as soon as no problem is active, and
  `cond` runs only the taken branch: a host read that costs nothing on
  the CPU and gives the same bits as the frozen rounds or the select.
  Only CPU tensors are ever read (`_host_flag` raises on any other).

A body captured into a conditional node runs on a side stream of its
own (one a nesting depth, made and warmed outside the capture); its
allocations go to the capture's private memory pool.  A failed build of
graph_cond.cu, or a node that cannot be added, raises: there is no
fallback to the fixed-cap capture.

`graph_capture` also keeps a record of the program's decisions: one
int32 slot a WHILE node (its iterations) and one a `cond` (its
predicate), zeroed at the start of every replay; `recording()` keeps the
same record for an eager run (each loop's active rounds, each cond's
predicate), so a replay can be held against the eager step.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import threading
from dataclasses import dataclass, field

import torch
from torch.utils import _pytree as pytree

from vslam_tpu_torch.ops.cuda_build import CudaLibrary

_IF, _WHILE = 0, 1
MAX_DEPTH = 4  # nesting depth of conditional bodies (a WHILE in an IF is 2)
MAX_SLOTS = 512  # record slots of one captured program

_library = CudaLibrary("graph_cond.cu")
_bound = False
_local = threading.local()


def library() -> ctypes.CDLL:
    """graph_cond.cu, built at first use (raises if nvcc fails)."""
    global _bound
    lib = _library.load()
    if not _bound:
        vp = ctypes.c_void_p
        lib.gc_begin.restype = ctypes.c_int
        lib.gc_begin.argtypes = [vp, vp, ctypes.c_int, vp, ctypes.c_int, vp, ctypes.c_int,
                                 ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong)]
        lib.gc_end.restype = ctypes.c_int
        lib.gc_end.argtypes = [vp, ctypes.c_ulonglong, ctypes.c_int, vp, ctypes.c_int, vp,
                               ctypes.c_int]
        _bound = True
    return lib


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"graph_cond.cu: {what} failed with cudaError {err}")


def _host_flag(t: torch.Tensor) -> bool:
    """The value of a CPU bool tensor (the CPU route's free read)."""
    if t.device.type != "cpu":
        raise RuntimeError(f"control: host read of a {t.device.type} tensor")
    return bool(t.numpy().any())


def _per_problem(flag: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return flag.reshape(flag.shape + (1,) * (like.dim() - flag.dim()))


# ---------------------------------------------------------------------------
# The record of a program's decisions
# ---------------------------------------------------------------------------

@dataclass
class Entry:
    """One WHILE loop ("while": its rounds) or one cond ("if": its
    predicate); `parent` is (index of the enclosing cond's entry, the
    branch) or None at the top level."""

    kind: str
    parent: tuple[int, bool] | None
    value: torch.Tensor  # int32 scalar (a view of a captured program's slots)
    name: str = ""


@dataclass
class Record:
    entries: list[Entry] = field(default_factory=list)
    _branch: list[tuple[int, bool]] = field(default_factory=list)
    # A capture's slots, which every replay zeroes: whoever replays the
    # graph keeps its Record, and the Record keeps the slots' memory from
    # going back to the allocator (a program with no conditional node
    # has no entry that would).
    slots: torch.Tensor | None = None

    def add(self, kind: str, value: torch.Tensor, name: str = "") -> int:
        parent = self._branch[-1] if self._branch else None
        self.entries.append(Entry(kind, parent, value, name))
        return len(self.entries) - 1

    @contextlib.contextmanager
    def branch(self, index: int, taken: bool):
        self._branch.append((index, taken))
        try:
            yield
        finally:
            self._branch.pop()

    def read(self) -> list[tuple[str, tuple[int, bool] | None, int]]:
        """(kind, parent, value) of every entry, read to the host."""
        return [(e.kind, e.parent, int(e.value)) for e in self.entries]

    def names(self) -> list[str]:
        return [e.name for e in self.entries]

    def reached(self, values) -> list[bool]:
        """Whether each entry of `values` (from read()) was reached: every
        enclosing cond took the entry's branch."""
        out = []
        for _, parent, _ in values:
            out.append(parent is None or (out[parent[0]]
                                          and bool(values[parent[0]][2]) == parent[1]))
        return out


@contextlib.contextmanager
def masked():
    """Inside the block the CPU takes the card's eager route: loops run to
    their cap with frozen state and conds compute both branches and
    select, reading nothing (tests hold the CPU's early exit to it)."""
    prev = getattr(_local, "masked", False)
    _local.masked = True
    try:
        yield
    finally:
        _local.masked = prev


def _host_route(tensors) -> bool:
    return (not getattr(_local, "masked", False)
            and all(t.device.type == "cpu" for t in tensors))


def _eager_record() -> Record | None:
    return getattr(_local, "eager", None)


@contextlib.contextmanager
def recording():
    """Keeps the record of the eager loops and conds run inside the block
    (counts on the device; read them with Record.read())."""
    rec = Record()
    prev = getattr(_local, "eager", None)
    _local.eager = rec
    try:
        yield rec
    finally:
        _local.eager = prev


# ---------------------------------------------------------------------------
# Capture
# ---------------------------------------------------------------------------

_streams: dict[torch.device, list] = {}


def _side_streams(device: torch.device) -> list:
    """The side streams that capture conditional bodies on `device`, one a
    nesting depth: made once, from the high-priority pool (torch's
    capture stream comes from the default one), each with its cuBLAS
    handle and workspace made outside any capture by a first product."""
    if device not in _streams:
        streams = [torch.cuda.Stream(device, priority=-1) for _ in range(MAX_DEPTH)]
        if len({s.cuda_stream for s in streams}) != MAX_DEPTH:
            raise RuntimeError("control: the stream pool gave one stream twice")
        a = torch.ones((2, 3, 3), device=device)
        for s in streams:
            s.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(s):
                torch.bmm(a, a)
                torch.mm(a[0], a[0])
                torch.einsum("bij,bjk->bik", a, a)
        torch.cuda.synchronize(device)
        _streams[device] = streams
    return _streams[device]


class _Capture:
    """The conditional-node state of one graph capture on one device."""

    def __init__(self, device: torch.device):
        self.device = device
        self.lib = library()
        self.streams = _side_streams(device)
        self.depth = 0
        self.pool = None
        self.routed = False
        self.slots = torch.zeros(MAX_SLOTS, dtype=torch.int32, device=device)
        self.n_slots = 0
        self.record = Record(slots=self.slots)

    def slot(self) -> torch.Tensor:
        if self.n_slots == MAX_SLOTS:
            raise RuntimeError(f"control: more than {MAX_SLOTS} conditional nodes in one "
                               "capture")
        self.n_slots += 1
        return self.slots[self.n_slots - 1]

    def _route_pool(self):
        """Send every allocation of the capture, the side streams' too, to
        the graph's private pool (torch's own filter takes only the
        capture stream's)."""
        if self.routed:
            return
        dev = self.device.index
        torch._C._cuda_endAllocateToPool(dev, self.pool)
        torch._C._cuda_beginAllocateToPool(dev, self.pool)
        torch._C._cuda_releasePool(dev, self.pool)  # begin took a second reference
        self.routed = True

    @contextlib.contextmanager
    def body(self, kind: int, flags: torch.Tensor, counter: torch.Tensor | None = None,
             max_iters: int = 0, negate: bool = False):
        """Capture the block as the body of a conditional node added after
        the current stream's work."""
        if flags.dtype != torch.bool or not flags.is_contiguous() or flags.device != self.device:
            raise ValueError("control: node flags must be a contiguous bool tensor on "
                             f"{self.device}")
        if self.depth == MAX_DEPTH:
            raise RuntimeError(f"control: conditional nodes nested deeper than {MAX_DEPTH}")
        self._route_pool()
        parent = torch.cuda.current_stream(self.device)
        side = self.streams[self.depth]
        cptr = None if counter is None else counter.data_ptr()
        handle = ctypes.c_ulonglong()
        _check(self.lib.gc_begin(parent.cuda_stream, side.cuda_stream, kind, flags.data_ptr(),
                                 flags.numel(), cptr, max_iters, int(negate),
                                 ctypes.byref(handle)), "adding a conditional node")
        self.depth += 1
        try:
            with torch.cuda.stream(side):
                yield
            _check(self.lib.gc_end(side.cuda_stream, handle.value, kind, flags.data_ptr(),
                                   flags.numel(), cptr, max_iters),
                   "ending a conditional body")
        finally:
            self.depth -= 1


def _capture() -> _Capture | None:
    """The conditional-node state when the current stream is capturing;
    raises for a capture that graph_capture did not start."""
    if not torch.cuda.is_available() or not torch.cuda.is_current_stream_capturing():
        return None
    ctx = getattr(_local, "capture", None)
    if ctx is None:
        raise RuntimeError("control: a conditional node needs a capture started with "
                           "control.graph_capture")
    return ctx


@contextlib.contextmanager
def graph_capture(graph: torch.cuda.CUDAGraph, device=None, pool=None):
    """torch.cuda.graph(graph) with conditional nodes: while_loop and cond
    inside the block become WHILE and IF nodes.  Yields the capture's
    Record (its values are the slots every replay writes): keep it as
    long as the graph is replayed, since it holds the slots.  `pool` (a
    torch.cuda.graph_pool_handle()) puts the graph's intermediates in a
    pool shared with other graphs that are never replayed concurrently
    (default: a private pool of its own)."""
    index = None if device is None else torch.device(device).index
    device = torch.device("cuda", torch.cuda.current_device() if index is None else index)
    if getattr(_local, "capture", None) is not None:
        raise RuntimeError("control.graph_capture: a capture is already under way")
    ctx = _Capture(device)
    ctx.pool = torch.cuda.graph_pool_handle() if pool is None else pool
    _local.capture = ctx
    # No automatic collection inside a capture: a dead cycle that holds a
    # CUDAGraph, freed there, destroys that graph while the stream is
    # capturing, which invalidates the capture (torch.cuda.graph no longer
    # collects before it begins).  Such cycles are freed after the capture.
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=ctx.pool):
            capturing = torch.cuda.current_stream(device).cuda_stream
            if capturing in {s.cuda_stream for s in ctx.streams}:
                raise RuntimeError("control: a side stream is the capture stream")
            ctx.slots.zero_()
            yield ctx.record
    finally:
        _local.capture = None
        if collecting:
            gc.enable()


# ---------------------------------------------------------------------------
# while_loop and cond
# ---------------------------------------------------------------------------

def while_loop(cond_fn, body_fn, state, max_iters: int, name: str = ""):
    """The JAX package's lax.while_loop over a batch of problems.

    state: a tuple of tensors; cond_fn(state) -> bool (B,) (or a scalar):
    which problems go on; body_fn(state) -> a new state of the same
    shapes and types.  A problem whose condition fails keeps its state
    from then on (the loop selects with the condition), and the loop ends
    when no problem goes on or after max_iters rounds.  Returns the final
    state as a tuple; `name` labels the loop in the record."""
    state = tuple(state)
    ctx = _capture()
    if ctx is not None:
        return _captured_while(ctx, cond_fn, body_fn, state, max_iters, name)
    rec = _eager_record()
    count = None
    host = _host_route(state)
    for _ in range(max_iters):
        active = cond_fn(state)
        if host and not _host_flag(active):
            break
        if rec is not None:
            go = active.any().to(torch.int32)
            count = go if count is None else count + go
        new = body_fn(state)
        state = tuple(torch.where(_per_problem(active, s), n, s) for n, s in zip(new, state))
    if rec is not None:
        dev = state[0].device
        rec.add("while", torch.zeros((), dtype=torch.int32, device=dev)
                if count is None else count, name)
    return state


def _captured_while(ctx: _Capture, cond_fn, body_fn, state, max_iters, name):
    bufs = tuple(s.clone() for s in state)
    first = cond_fn(bufs)
    active = first.to(torch.bool).reshape(-1).clone()
    counter = ctx.slot()
    ctx.record.add("while", counter, name)
    with ctx.body(_WHILE, active, counter, max_iters):
        new = body_fn(bufs)
        flags = active.reshape(first.shape)
        sel = [torch.where(_per_problem(flags, b), n, b) for n, b in zip(new, bufs)]
        for b, s in zip(bufs, sel):
            b.copy_(s)
        active.copy_(cond_fn(bufs).reshape(-1))
    return bufs


def cond(pred: torch.Tensor, true_fn, false_fn, operands=(), name: str = ""):
    """The JAX package's lax.cond: true_fn(*operands) where the bool
    scalar pred holds, else false_fn(*operands).  The two branches return
    pytrees (tuples, NamedTuples) of tensors of the same structure,
    shapes and types, and write nothing in place.  `name` labels the cond
    in the record."""
    ctx = _capture()
    if ctx is not None:
        return _captured_cond(ctx, pred, true_fn, false_fn, operands, name)
    rec = _eager_record()
    idx = None if rec is None else rec.add("if", pred.to(torch.int32).reshape(()), name)
    branch = (lambda taken: contextlib.nullcontext()) if rec is None else (
        lambda taken: rec.branch(idx, taken))
    if _host_route([pred]):
        take = _host_flag(pred)
        with branch(take):
            return true_fn(*operands) if take else false_fn(*operands)
    with branch(True):
        t = true_fn(*operands)
    with branch(False):
        f = false_fn(*operands)
    return pytree.tree_map(lambda a, b: torch.where(_per_problem(pred, a), a, b), t, f)


def _captured_cond(ctx: _Capture, pred, true_fn, false_fn, operands, name):
    flag = pred.to(torch.bool).reshape(1).clone()
    slot = ctx.slot()
    slot.copy_(flag[0])
    idx = ctx.record.add("if", slot, name)
    # The true branch's outputs are fresh tensors of the graph's pool (a
    # branch may return an operand itself), which the other branch's
    # node overwrites when it is the one taken.
    with ctx.body(_IF, flag), ctx.record.branch(idx, True):
        leaves, spec = pytree.tree_flatten(true_fn(*operands))
        out = [t.clone() for t in leaves]
    with ctx.body(_IF, flag, negate=True), ctx.record.branch(idx, False):
        other, other_spec = pytree.tree_flatten(false_fn(*operands))
        if other_spec != spec or any(a.shape != b.shape or a.dtype != b.dtype
                                     for a, b in zip(out, other)):
            raise ValueError("control.cond: the branches return different structures, "
                             "shapes or types")
        for o, t in zip(out, other):
            o.copy_(t)
    return pytree.tree_unflatten(out, spec)
