"""The queue renderer's per-lane ray queue (``ops.render.RayQueue``): pop and
the push of a pop's two children, with a hand-written backward that touches
only the rows a step read or wrote.

No TPU kernel stands behind this module: the JAX package's ``RayQueue``
(``raytracing_tests_tpu/ops/render.py:179-251``) pushes by a one-hot
``where`` and pops by a one-hot sum over the Q records, and XLA fuses both.
Their counterpart here is four hand-written CUDA kernels (``csrc/queue.cu``),
one thread a lane: ``queue_pop``, ``queue_push2`` (a pop's children in push
order, or the primaries alone), and their backward ``queue_pop_grad`` and
``queue_push2_grad``.  Pop and push move values and compute nothing from
them, so the tangent of each is its forward kernel run on the tangent stacks
(counted as the forward).

The layout stays the port's: each field slot-major, ``(Q + 1, B, width)``,
record ``s`` of lane ``b`` at row ``s * B + b``, the spill slot last.

**The gradient.**  A pop and a push pair change the stacks in place (a pop
changes no value, but says it did: ``ctx.mark_dirty``), so the steps of one
trace form one chain in which each version of a stack has one consumer, the
next step.  The stack's gradient is one buffer a field passed down that
chain: a pop's backward adds its popped values' gradient into the rows it
read, a push pair's backward reads its children's gradient from the rows it
wrote and zeroes those rows.  Each step saves the sizes before it (and a
push its masks) as device tensors, from which it finds its rows again.  So
the backward moves O(B) bytes a step; the one pass over a whole stack is the
zero fill of the buffer where the first gradient arrives (the last pop whose
values reach the loss).

Changing the incoming gradient in place is sound only while that tensor is
the chain's own: ``GradBuffers`` keeps a weak reference to the buffer a step
handed back, with its version, and the next step writes into a gradient in
place only if it is that very tensor, unchanged.  Anything else -- a stack
that also reaches a second consumer (autograd sums the two into another
tensor), a gradient that autograd materialised or expanded, a transform's
wrapper -- is copied once, contiguous, and the copy becomes the chain's.  A
tensor hook on a stack that keeps its gradient must clone it.

``queue_pop_plain``, ``queue_push_plain`` and ``queue_push2_plain`` are
``RayQueue``'s pop and push as they were (``index_select`` and
``index_copy``, out of place under autograd): RayQueue's route for tensors
that lie on the CPU.  ``pop_rows_plain``, ``push2_rows_plain``,
``queue_pop_grad_plain`` and ``queue_push2_grad_plain`` are the kernels'
plain versions (in place, like them), the autograd functions' route on the
CPU.  For CUDA tensors ``pop`` and ``push2`` launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from raytracing_tests_tpu_torch.kernels import _build

FIELDS = ("origin", "direction", "contribution", "bounced")
MEDIA = ("medium", "parent_medium")
# The float fields, in the kernels' order, and their widths a lane.
FLOATS = ("origin", "direction", "contribution", "medium", "parent_medium")
WIDTHS = {"origin": 3, "direction": 3, "contribution": 1, "medium": 1, "parent_medium": 1}
# What a push writes for a child's absent values: the media's air (a
# tangent writes zero for an absent child tangent).
AIR = {n: 1.0 for n in MEDIA}


# ----------------------------------------------------------------------------
# RayQueue's pop and push as they were: its route for CPU tensors
# ----------------------------------------------------------------------------


def queue_push_plain(queue, mask, origin, direction, contribution, bounced,
                     medium=None, parent_medium=None):
    """Conditional push at position ``size`` for lanes in ``mask``
    (updates the queue in place).  Returns the number of dropped pushes
    (a 0-dim int64 tensor on the queue's device) -- pushes beyond capacity
    are dropped like the reference stack, but the count is surfaced so
    renderers can report honest ray accounting.  ``medium`` /
    ``parent_medium`` default to air (1.0); a queue without media takes
    neither.

    Static shapes, no host read: every lane writes its one record, at
    ``size`` where it pushes and in its spill slot where it cannot, so
    the Q records are the JAX package's one-hot ``where`` bit for bit at
    O(B) writes instead of O(B Q)."""
    q = queue.capacity
    can = mask & (queue.size < q)
    n_dropped = torch.sum(mask & ~can)
    at = queue._rows(torch.where(can, queue.size, torch.full_like(queue.size, q)))
    values = dict(origin=origin, direction=direction, contribution=contribution,
                  bounced=bounced)
    if queue.media:
        air = torch.ones_like(contribution)
        values.update({n: air if m is None else m
                       for n, m in zip(MEDIA, (medium, parent_medium))})
    elif medium is not None or parent_medium is not None:
        raise ValueError("a queue made without media stores none (RayQueue.create)")
    for name, value in values.items():
        dst = queue.stacks[name]
        rows = dst.view((-1,) + tuple(dst.shape[2:]))
        value = value.to(dst.dtype)
        if rows.requires_grad or value.requires_grad:
            # Under autograd a pop's gather keeps the stack it read:
            # write a new one instead of changing that one in place.
            queue.stacks[name] = rows.index_copy(0, at, value).view(dst.shape)
        else:
            rows.index_copy_(0, at, value)
    queue.size = queue.size + can.to(torch.int64)
    return n_dropped


def queue_push2_plain(queue, first, second=None):
    """``queue_push_plain`` of ``first`` and then of ``second`` (each
    ``(mask, origin, direction, contribution, bounced, medium,
    parent_medium)``, the media optional; ``second`` None: ``first`` alone)
    -> the drops of both."""
    dropped = queue_push_plain(queue, *first)
    if second is not None:
        dropped = dropped + queue_push_plain(queue, *second)
    return dropped


def queue_pop_plain(queue):
    """LIFO pop -> (active, o, d, contribution, bounced, medium,
    parent_medium), the media None in a queue without them; lanes with
    empty queues return zeros and active=False."""
    active = queue.size > 0
    at = queue._rows(torch.clamp_min(queue.size - 1, 0))
    out = {}
    for name, src in queue.stacks.items():
        got = src.view((-1,) + tuple(src.shape[2:])).index_select(0, at)
        out[name] = got.masked_fill_(~active.view((-1,) + (1,) * (got.dim() - 1)), 0)
    queue.size = queue.size - active.to(torch.int64)
    return (active, *(out[n] for n in FIELDS), *(out.get(n) for n in MEDIA))


# ----------------------------------------------------------------------------
# The kernels' plain versions: in place, like them
# ----------------------------------------------------------------------------


def _row_view(t):
    return t.view((-1,) + tuple(t.shape[2:]))


def _rows_at(size, slot):
    B = size.shape[0]
    return torch.arange(B, device=size.device) + slot * B


def pop_rows_plain(stacks, size, full: bool = True):
    """``queue_pop``'s plain version: each field of ``stacks`` ({name:
    (Q + 1, B, ...)}) at each lane's record ``size - 1``, zeros where
    ``size`` is 0 -> (active, the popped {name: (B, ...)}, the sizes after);
    with ``full`` False (a tangent) only the popped values, and the first
    and last None."""
    active = size > 0
    at = _rows_at(size, torch.clamp_min(size - 1, 0))
    out = {n: _row_view(s).index_select(0, at).masked_fill_(
        ~active.view((-1,) + (1,) * (s.dim() - 2)), 0) for n, s in stacks.items()}
    if not full:
        return None, out, None
    return active, out, size - active.to(torch.int64)


def push2_rows_plain(stacks, size, children, absent, full: bool = True):
    """``queue_push2``'s plain version, in place on ``stacks`` ({name:
    (Q + 1, B, ...)}): each child of ``children`` (a mask and {name: (B,
    ...) or None}) in turn, at each lane's ``size`` where its mask is set
    and there is room, else at the spill slot; None values write
    ``absent[name]``.  -> (the sizes after, the dropped pushes as a 0-dim
    int64), both None where ``full`` is False (a tangent)."""
    q = next(iter(stacks.values())).shape[0] - 1
    dropped = torch.zeros((), dtype=torch.int64, device=size.device)
    for mask, values in children:
        can = mask & (size < q)
        dropped = dropped + torch.sum(mask & ~can)
        at = _rows_at(size, torch.where(can, size, torch.full_like(size, q)))
        for n, s in stacks.items():
            v = values.get(n)
            if v is None:
                v = torch.full(s.shape[1:], absent.get(n, 0.0), dtype=s.dtype, device=s.device)
            _row_view(s).index_copy_(0, at, v.to(s.dtype))
        size = size + can.to(torch.int64)
    return (size, dropped) if full else (None, None)


def queue_pop_grad_plain(G, size, grads):
    """``queue_pop_grad``'s plain version, in place on ``G`` ({name: the
    stack's gradient (Q + 1, B, ...)}): each active lane's popped gradient
    ``grads[name]`` (B, ...) added into the row it read."""
    active = size > 0
    rows = _rows_at(size, size - 1)[active]
    for n, g in grads.items():
        if g is not None and n in G:
            flat = _row_view(G[n])
            flat.index_copy_(0, rows, flat.index_select(0, rows) + g[active])


def _push_rows(size, masks, q):
    rows = []
    for mask in masks:
        can = mask & (size < q)
        rows.append(_rows_at(size, torch.where(can, size, torch.full_like(size, q))))
        size = size + can.to(torch.int64)
    return rows


def queue_push2_grad_plain(G, size, masks, want):
    """``queue_push2_grad``'s plain version: each child's gradient, the
    rows of ``G`` ({name: the stack's gradient}) it was written at (the
    first child's zero where both went to the spill slot), then those rows
    zeroed in place.  ``size``: before the push; ``want``: one set of names
    a child -> one {name: (B, ...)} a child."""
    q = next(iter(G.values())).shape[0] - 1
    rows = _push_rows(size, masks, q)
    out = [{} for _ in masks]
    for n, g in G.items():
        flat = _row_view(g)
        for j, at in enumerate(rows):
            if n in want[j]:
                got = flat.index_select(0, at)
                if j == 0 and len(rows) == 2:  # the second child overwrote the first
                    got = got.masked_fill_((rows[0] == rows[1]).view(
                        (-1,) + (1,) * (got.dim() - 1)), 0)
                out[j][n] = got
        for at in rows:
            flat.index_fill_(0, at, 0)
    return out


# ----------------------------------------------------------------------------
# The launches
# ----------------------------------------------------------------------------


def _check(name, t, dtype, shape, dev):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != dev
            or not t.is_contiguous()):
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device} (contiguous: "
                         f"{t.is_contiguous()}), expected {dtype} {tuple(shape)}, contiguous "
                         f"on {dev}")


def _lane_shape(B: int, name: str):
    return (B, WIDTHS[name]) if WIDTHS[name] > 1 else (B,)


def _checked_stacks(stacks, size):
    """(Q, B) of ``stacks`` and ``size``, checked."""
    dev = size.device
    _check("size", size, torch.int64, (size.shape[0],), dev)
    B = size.shape[0]
    any_stack = next(iter(stacks.values()))
    q1 = any_stack.shape[0] if any_stack.dim() >= 2 else -1
    if q1 < 1:
        raise ValueError(f"stack {tuple(any_stack.shape)}: expected (Q + 1, B, ...)")
    for n, s in stacks.items():
        if n == "bounced":
            _check("bounced stack", s, torch.int32, (q1, B), dev)
        elif n not in WIDTHS:
            raise ValueError(f"unknown field {n!r}")
        else:
            _check(f"{n} stack", s, torch.float32, (q1,) + _lane_shape(B, n), dev)
    return q1 - 1, B


def _floats(d):
    """The ``FLOATS`` of ``d`` (None where absent) as a ctypes array."""
    return (ctypes.c_void_p * len(FLOATS))(*[None if d.get(n) is None else d[n].data_ptr()
                                             for n in FLOATS])


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGS = {"rt_queue_pop": [_P, _P, _P, _P, _P, _P, _P, _LL, _P],
         "rt_queue_push2": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _P],
         "rt_queue_pop_grad": [_P, _P, _P, _LL, _P],
         "rt_queue_push2_grad": [_P, _P, _P, _P, _I, _LL, _I, _P]}


def _fn(name: str):
    fn = getattr(_build.load("queue"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGS[name]
        fn.restype = ctypes.c_int
    return fn


def _launch_pop(stacks, size, full: bool = True):
    """Check the arguments and launch ``rt_queue_pop`` on the current
    stream: ``pop_rows_plain``'s arguments and results.  With ``full`` the
    stacks hold ``bounced`` and it comes out too, among the popped values."""
    dev = size.device
    _, B = _checked_stacks(stacks, size)
    if full != ("bounced" in stacks):
        raise ValueError("a full pop reads the bounced stack; a tangent's reads none")
    _build.check_device(dev)
    out = {n: torch.empty(_lane_shape(B, n), dtype=torch.float32, device=dev)
           for n in FLOATS if n in stacks}
    active = size_out = bout = None
    if full:
        active = torch.empty(B, dtype=torch.bool, device=dev)
        size_out = torch.empty(B, dtype=torch.int64, device=dev)
        bout = torch.empty(B, dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    code = _fn("rt_queue_pop")(_floats(stacks), ptr(stacks.get("bounced")), size.data_ptr(),
                               _floats(out), ptr(bout), ptr(active), ptr(size_out), B,
                               _build.stream_of(dev))
    _build.check(code, "rt_queue_pop")
    if B:
        _build.LAUNCHES["queue_pop"] += 1
    if full:
        out["bounced"] = bout
    return active, out, size_out


def _launch_push2(stacks, size, children, absent=AIR, full: bool = True):
    """Check the arguments and launch ``rt_queue_push2`` on the current
    stream: ``push2_rows_plain``'s arguments and results, ``stacks``
    written in place.  With ``full`` each child's values hold ``bounced``
    (int32) and the stacks its stack."""
    dev = size.device
    Q, B = _checked_stacks(stacks, size)
    if not 1 <= len(children) <= 2:
        raise ValueError(f"{len(children)} children: a push pair takes one or two")
    if full != ("bounced" in stacks):
        raise ValueError("a full push writes the bounced stack; a tangent's writes none")
    for j, (mask, values) in enumerate(children):
        _check(f"mask {j}", mask, torch.bool, (B,), dev)
        for n, v in values.items():
            if v is None:
                continue
            if n == "bounced":
                _check(f"bounced {j}", v, torch.int32, (B,), dev)
            elif n not in stacks:
                raise ValueError(f"child {j} brings {n}, which the stacks do not hold")
            else:
                _check(f"{n} {j}", v, torch.float32, _lane_shape(B, n), dev)
        if full and values.get("bounced") is None:
            raise ValueError(f"child {j}: a full push writes bounced")
    _build.check_device(dev)
    size_out = dropped = None
    if full:
        size_out = torch.empty(B, dtype=torch.int64, device=dev)
        dropped = torch.zeros((), dtype=torch.int64, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    pad = [None] * (2 - len(children))
    vals = [v for _, values in children for v in _floats(values)] + pad * len(FLOATS)
    code = _fn("rt_queue_push2")(
        _floats(stacks), ptr(stacks.get("bounced")), size.data_ptr(), ptr(size_out),
        ptr(dropped), (ctypes.c_void_p * 2)(*[m.data_ptr() for m, _ in children], *pad),
        (ctypes.c_void_p * len(vals))(*vals),
        (ctypes.c_void_p * 2)(*[ptr(v.get("bounced")) for _, v in children], *pad),
        (ctypes.c_float * len(FLOATS))(*[float(absent.get(n, 0.0)) for n in FLOATS]),
        len(children), B, Q, _build.stream_of(dev))
    _build.check(code, "rt_queue_push2")
    if B:
        _build.LAUNCHES["queue_push2"] += 1
    return size_out, dropped


def _launch_pop_grad(G, size, grads):
    """Check the arguments and launch ``rt_queue_pop_grad`` on the current
    stream: ``queue_pop_grad_plain``'s, ``G`` added to in place."""
    dev = size.device
    _, B = _checked_stacks(G, size)
    if "bounced" in G:
        raise ValueError("bounced carries no gradient")
    for n, g in grads.items():
        if g is not None:
            _check(f"gradient of {n}", g, torch.float32, _lane_shape(B, n), dev)
    _build.check_device(dev)
    g = {n: v for n, v in grads.items() if n in G and v is not None}
    code = _fn("rt_queue_pop_grad")(_floats(G), _floats(g), size.data_ptr(), B,
                                    _build.stream_of(dev))
    _build.check(code, "rt_queue_pop_grad")
    if B and g:
        _build.LAUNCHES["queue_pop_grad"] += 1


def _launch_push2_grad(G, size, masks, want):
    """Check the arguments and launch ``rt_queue_push2_grad`` on the current
    stream: ``queue_push2_grad_plain``'s arguments and results, the written
    rows of ``G`` zeroed in place."""
    dev = size.device
    Q, B = _checked_stacks(G, size)
    if "bounced" in G:
        raise ValueError("bounced carries no gradient")
    if not 1 <= len(masks) <= 2 or len(want) != len(masks):
        raise ValueError(f"{len(masks)} masks and {len(want)} sets of gradients wanted: "
                         "a push pair has one or two children")
    for j, mask in enumerate(masks):
        _check(f"mask {j}", mask, torch.bool, (B,), dev)
    _build.check_device(dev)
    outs = [{n: torch.empty(_lane_shape(B, n), dtype=torch.float32, device=dev)
             for n in FLOATS if n in G and n in w} for w in want]
    pad = [None] * (2 - len(masks))
    ptrs = [p for o in outs for p in _floats(o)] + pad * len(FLOATS)
    code = _fn("rt_queue_push2_grad")(
        _floats(G), (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_void_p * 2)(*[m.data_ptr() for m in masks], *pad), size.data_ptr(),
        len(masks), B, Q, _build.stream_of(dev))
    _build.check(code, "rt_queue_push2_grad")
    if B and G:
        _build.LAUNCHES["queue_push2_grad"] += 1
    return outs


# ----------------------------------------------------------------------------
# Routes: the plain versions for CPU tensors, else the kernels.  A backward's
# or a tangent's launch goes through ``_build.constant``, which hands the
# kernel the tensors themselves under ``torch.func``; the in-place writes land
# in their storage.
# ----------------------------------------------------------------------------


def _pop(stacks, size):
    """A pop's forward -> (active, popped, sizes after)."""
    if size.device.type == "cpu":
        return pop_rows_plain(stacks, size)
    return _launch_pop(stacks, size)


def _push2(stacks, size, children):
    """A push pair's forward, in place -> (sizes after, dropped)."""
    if size.device.type == "cpu":
        return push2_rows_plain(stacks, size, children, AIR)
    return _launch_push2(stacks, size, children)


def _pop_tangent(stacks, size):
    """The tangent of a pop: the pop of the tangent stacks -> {name:
    popped tangent}."""
    if size.device.type == "cpu":
        return pop_rows_plain(stacks, size, full=False)[1]
    return _pop_tangent_kernel(stacks, size)


def _pop_tangent_kernel(stacks, size):
    names = list(stacks)

    def launch(s, *x):
        got = _launch_pop(dict(zip(names, x)), s, full=False)[1]
        return tuple(got[n] for n in names)

    return dict(zip(names, _build.constant(launch, size, *stacks.values())))


def _push2_tangent(stacks, size, children):
    """The tangent of a push pair: the push of the children's tangents (None:
    zero) into the tangent stacks, in place."""
    if size.device.type == "cpu":
        push2_rows_plain(stacks, size, children, {}, full=False)
    else:
        _push2_tangent_kernel(stacks, size, children)


def _push2_tangent_kernel(stacks, size, children):
    names = list(stacks)
    flat, back = _build.given([v for _, values in children for v in
                               (values.get(n) for n in names)])

    def launch(s, *x):
        st = dict(zip(names, x[:len(names)]))
        ms = x[len(names):len(names) + len(children)]
        vals = iter(back(x[len(names) + len(children):]))
        _launch_push2(st, s, [(m, {n: next(vals) for n in names}) for m in ms], {},
                      full=False)
        return ()

    _build.constant(launch, size, *stacks.values(), *[m for m, _ in children], *flat)


def _pop_grad(G, size, grads):
    """A pop's backward, in place on ``G``."""
    if size.device.type == "cpu":
        return queue_pop_grad_plain(G, size, grads)
    return _pop_grad_kernel(G, size, grads)


def _pop_grad_kernel(G, size, grads):
    names, gnames = list(G), [n for n, g in grads.items() if g is not None and n in G]

    def launch(s, *x):
        _launch_pop_grad(dict(zip(names, x[:len(names)])), s,
                         dict(zip(gnames, x[len(names):])))
        return ()

    _build.constant(launch, size, *G.values(), *[grads[n] for n in gnames])


def _push2_grad(G, size, masks, want):
    """A push pair's backward -> each child's {name: gradient}; the rows it
    wrote zeroed in ``G``."""
    if size.device.type == "cpu":
        return queue_push2_grad_plain(G, size, masks, want)
    return _push2_grad_kernel(G, size, masks, want)


def _push2_grad_kernel(G, size, masks, want):
    names = list(G)
    keys = [(j, n) for j, w in enumerate(want) for n in FLOATS if n in G and n in w]

    def launch(s, *x):
        outs = _launch_push2_grad(dict(zip(names, x[len(masks):])), s, x[:len(masks)], want)
        return tuple(outs[j][n] for j, n in keys)

    got = _build.constant(launch, size, *masks, *G.values())
    out = [{} for _ in masks]
    for (j, n), g in zip(keys, got):
        out[j][n] = g
    return out


# ----------------------------------------------------------------------------
# The autograd functions
# ----------------------------------------------------------------------------


class GradBuffers:
    """A queue's stack gradients as its backward passes them down the chain
    of its steps: which tensor a step handed back for each field, and its
    version then.  ``take`` gives a step a gradient it may change in place:
    the incoming one where it is that very tensor, unchanged, else a
    contiguous copy (zeros where none came)."""

    def __init__(self):
        self._kept = {}

    def take(self, name, grad, like):
        if grad is None:
            shape, dtype, device = like
            return torch.zeros(shape, dtype=dtype, device=device)
        kept = self._kept.get(name)
        if (kept is not None and kept[0]() is grad and kept[1] == grad._version
                and grad.is_contiguous()):
            return grad
        return grad.clone(memory_format=torch.contiguous_format)

    def hand(self, name, grad):
        self._kept[name] = (weakref.ref(grad), grad._version)


def _like(stacks):
    return {n: (tuple(s.shape), s.dtype, s.device) for n, s in zip(FLOATS, stacks)
            if s is not None}


class _QueuePop(torch.autograd.Function):
    """(buffers, size, the bounced stack, the ``FLOATS`` stacks) -> (active,
    bounced, the sizes after, the popped ``FLOATS``, the stacks, marked
    dirty)."""

    @staticmethod
    def forward(buffers, size, bstack, *stacks):
        st = {n: s for n, s in zip(FLOATS, stacks) if s is not None}
        st["bounced"] = bstack
        active, out, size_out = _pop(st, size)
        return (active, out["bounced"], size_out, *[out.get(n) for n in FLOATS], *stacks)

    @staticmethod
    def setup_context(ctx, inputs, output):
        buffers, size, _, *stacks = inputs
        ctx.mark_dirty(*[s for s in stacks if s is not None])
        ctx.mark_non_differentiable(*output[:3])
        ctx.save_for_backward(size)
        ctx.save_for_forward(size)
        ctx.buffers, ctx.like = buffers, _like(stacks)
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, _active, _bounced, _size, *grads):
        (size,) = ctx.saved_tensors
        n = len(FLOATS)
        popped, incoming = dict(zip(FLOATS, grads[:n])), dict(zip(FLOATS, grads[n:]))
        need = dict(zip(FLOATS, ctx.needs_input_grad[3:]))
        out = {}
        G = {}
        for name in ctx.like:
            if not need[name]:
                continue
            if popped[name] is None:
                out[name] = incoming[name]  # passed through unchanged
            else:
                G[name] = ctx.buffers.take(name, incoming[name], ctx.like[name])
        if G:
            _pop_grad(G, size, {k: popped[k].contiguous() for k in G})
            for name, g in G.items():
                ctx.buffers.hand(name, g)
                out[name] = g
        return (None, None, None, *[out.get(k) for k in FLOATS])

    @staticmethod
    def jvp(ctx, _buffers, _size, _bstack, *tangents):
        (size,) = ctx.saved_tensors
        t = {n: x for n, x in zip(FLOATS, tangents) if x is not None and n in ctx.like}
        got = _pop_tangent({n: x.contiguous() for n, x in t.items()}, size) if t else {}
        for x in t.values():  # the stacks are dirty outputs: their tangents too
            torch.autograd.graph.increment_version(x)
        return (None, None, None, *[got.get(n) for n in FLOATS], *[t.get(n) for n in FLOATS])


class _QueuePush2(torch.autograd.Function):
    """(buffers, children, size, mask and bounced of each child (None
    beyond ``children``), the bounced stack, each child's ``FLOATS`` and
    the ``FLOATS`` stacks) -> (the sizes after, dropped, the stacks, marked
    dirty)."""

    @staticmethod
    def forward(buffers, children, size, m1, b1, m2, b2, bstack, *floats):
        n = len(FLOATS)
        st = {k: s for k, s in zip(FLOATS, floats[2 * n:]) if s is not None}
        st["bounced"] = bstack
        kids = [(m, dict(zip(FLOATS, floats[j * n:(j + 1) * n]), bounced=b))
                for j, (m, b) in enumerate(((m1, b1), (m2, b2))[:children])]
        size_out, dropped = _push2(st, size, kids)
        return (size_out, dropped, bstack, *floats[2 * n:])

    @staticmethod
    def setup_context(ctx, inputs, output):
        buffers, children, size, m1, _, m2, _, bstack, *floats = inputs
        stacks = floats[2 * len(FLOATS):]
        ctx.mark_dirty(bstack, *[s for s in stacks if s is not None])
        ctx.mark_non_differentiable(output[0], output[1])
        masks = (m1, m2)[:children]
        ctx.save_for_backward(size, *masks)
        ctx.save_for_forward(size, *masks)
        ctx.buffers, ctx.like = buffers, _like(stacks)
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, _size, _dropped, _bstack, *grads):
        size, *masks = ctx.saved_tensors
        n = len(FLOATS)
        need = ctx.needs_input_grad[8:]
        want = [{k for i, k in enumerate(FLOATS) if need[j * n + i]} for j in range(len(masks))]
        G = {k: ctx.buffers.take(k, g, ctx.like[k]) for k, g in zip(FLOATS, grads)
             if g is not None and k in ctx.like}
        kids = [{} for _ in masks]
        if G:
            kids = _push2_grad(G, size, masks, want)
            for k, g in G.items():
                ctx.buffers.hand(k, g)
        kid_grads = [kids[j].get(k) if j < len(masks) else None for j in range(2) for k in FLOATS]
        return ((None,) * 8 + tuple(kid_grads)
                + tuple(G.get(k) if need[2 * n + i] else None for i, k in enumerate(FLOATS)))

    @staticmethod
    def jvp(ctx, *tangents):
        size, *masks = ctx.saved_tensors
        n = len(FLOATS)
        kids = [dict(zip(FLOATS, tangents[8 + j * n:8 + (j + 1) * n])) for j in range(len(masks))]
        out = {}
        for k, t in zip(FLOATS, tangents[8 + 2 * n:]):
            if k not in ctx.like or (t is None and all(c[k] is None for c in kids)):
                continue
            if t is None:
                shape, dtype, device = ctx.like[k]
                t = torch.zeros(shape, dtype=dtype, device=device)
            out[k] = t
        if out:
            _push2_tangent(out, size, [(m, {k: None if c[k] is None else c[k].contiguous()
                                             for k in out}) for m, c in zip(masks, kids)])
            for t in out.values():  # the stacks are dirty outputs: their tangents too
                torch.autograd.graph.increment_version(t)
        return (None, None, None, *[out.get(k) for k in FLOATS])


# ----------------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------------


def queue_pop(queue):
    """``queue_pop_plain`` through ``_QueuePop``: on CUDA tensors the
    ``queue_pop`` kernel, whose backward is ``queue_pop_grad`` and whose
    tangent is ``queue_pop`` on the tangent stacks; the stacks change in
    place (their values do not) and the sizes are new."""
    st = queue.stacks
    got = _QueuePop.apply(queue.grads, queue.size, st["bounced"], *[st.get(n) for n in FLOATS])
    active, bounced, queue.size = got[:3]
    n = len(FLOATS)
    popped = dict(zip(FLOATS, got[3:3 + n]))
    for name, s in zip(FLOATS, got[3 + n:]):
        if s is not None:
            st[name] = s
    return (active, popped["origin"], popped["direction"], popped["contribution"], bounced,
            popped["medium"], popped["parent_medium"])


def _child(queue, child):
    """A child as ``RayQueue.push2`` takes it -> (mask, bounced, its
    ``FLOATS``) for ``_QueuePush2``."""
    mask, origin, direction, contribution, bounced, *media = child
    media = (list(media) + [None, None])[:2]
    if not queue.media and any(m is not None for m in media):
        raise ValueError("a queue made without media stores none (RayQueue.create)")
    dt = queue.stacks["origin"].dtype
    f = lambda v: None if v is None else v.to(dt).contiguous()  # noqa: E731
    return (mask.to(torch.bool).contiguous(), bounced.to(torch.int32).contiguous(),
            [f(origin), f(direction), f(contribution)] + [f(m) for m in media])


def queue_push2(queue, first, second=None):
    """``queue_push2_plain`` through ``_QueuePush2``: on CUDA tensors one
    ``queue_push2`` launch for both children, whose backward is
    ``queue_push2_grad`` and whose tangent is ``queue_push2`` on the tangent
    stacks; the stacks change in place and the sizes are new.  -> the
    dropped pushes, a 0-dim int64."""
    kids = [_child(queue, c) for c in ((first,) if second is None else (first, second))]
    (m1, b1, v1), (m2, b2, v2) = kids[0], kids[1] if len(kids) == 2 else (None, None, [None] * 5)
    st = queue.stacks
    got = _QueuePush2.apply(queue.grads, len(kids), queue.size, m1, b1, m2, b2, st["bounced"],
                            *v1, *v2, *[st.get(n) for n in FLOATS])
    queue.size, dropped, st["bounced"] = got[:3]
    for name, s in zip(FLOATS, got[3:]):
        if s is not None:
            st[name] = s
    return dropped


def pop(queue):
    """``RayQueue.pop``: ``queue_pop_plain`` for a queue on the CPU, else
    ``queue_pop`` (the kernels)."""
    if queue.size.device.type == "cpu":
        return queue_pop_plain(queue)
    return queue_pop(queue)


def push2(queue, first, second=None):
    """``RayQueue.push2``: ``queue_push2_plain`` for a queue on the CPU, else
    ``queue_push2`` (the kernels)."""
    if queue.size.device.type == "cpu":
        return queue_push2_plain(queue, first, second)
    return queue_push2(queue, first, second)
