"""The gradient path's surrounding-refractive-index containment sum, with a
hand-written backward.

No TPU kernel stands behind this module: the JAX package's gradient path
sums the surrounding RI of the lanes that read it by the dense containment
sum (``raytracing_tests_tpu/ops/intersect.py:86-105``, reached from
``ops/render.py:324-329`` under a ``DiffAccel``), which XLA fuses into one
reduction that never writes its (points, rows, 3) intermediates.  Its
counterpart here is one pair of hand-written CUDA kernels
(``csrc/ri_sum.cu``): ``containment_ri``'s forward tests every (point, row)
in registers and adds the contained rows' RI in ascending row order in one
launch (counted as ``ri_sum``), saving only each point's count where its
sum exceeded 1; its backward, with respect to ``refractive_index`` alone
(containment is a boolean), recomputes the containment and adds each
point's share of its gradient into the rows in one launch
(``ri_sum_grad``), through a shared (N,) tile where 4 N bytes fit
``SMEM_BUDGET``, else by global atomics.

Forward-mode AD (``torch.func.jvp``): the tangent of the mean is the mean
of the contained rows' RI tangents, one launch (``ri_sum_jvp``) of the
forward's walk with each row's tangent in place of its RI, divided by the
forward's count.

``ri_sum_plain``, ``ri_sum_grad_plain`` and ``ri_sum_jvp_plain`` are the
forward, the backward and the tangent in plain PyTorch: the local point and
the row-order sum written out term by term as the kernels compute them, so
that the kernels' ``-fmad=false`` build equals the forward and the tangent
bit for bit.  ``containment_ri`` uses them only for tensors that lie on the
CPU; for CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch

from raytracing_tests_tpu_torch.core.geometry import CUBOID, ELLIPSOID
from raytracing_tests_tpu_torch.kernels import _build
from raytracing_tests_tpu_torch.kernels.sweep import nearest_ri_split

# Shared memory the backward's (N,) float tile may take: 6 144 rows (488 for
# grad_config, 1 032 for bvh1k); above it the backward adds straight into
# global memory.  With the kernels' 20 KB of staged rows it stays inside the
# 48 KB a block gets without raising its limit.
SMEM_BUDGET = 24 * 1024
MAX_SMEM_BUDGET = 28 * 1024

# The scene's fields the sum reads, in the kernels' argument order.
FIELDS = ("position", "delta_position", "rotation", "scale", "obj_type", "valid",
          "refractive_index")


def _inside(point, time_ratio, position, delta_position, rotation, scale, obj_type, valid,
            refractive_index):
    """(S, N) bool: does each live row (valid, RI not 1) contain each point,
    the local point computed term by term as ``csrc/ri_sum.cu`` computes
    it.  Outside autograd: containment is a boolean."""
    with torch.no_grad():
        omt = (1.0 - time_ratio)[:, None]
        rel = [(point[:, None, c] - position[None, :, c]) + omt * delta_position[None, :, c]
               for c in range(3)]
        loc = [((rotation[None, :, 0, i] * rel[0] + rotation[None, :, 1, i] * rel[1])
                + rotation[None, :, 2, i] * rel[2]) / scale[None, :, i] for i in range(3)]
        in_e = (loc[0] * loc[0] + loc[1] * loc[1]) + loc[2] * loc[2] <= 1.0
        in_c = (loc[0].abs() <= 0.5) & (loc[1].abs() <= 0.5) & (loc[2].abs() <= 0.5)
        live = valid & (refractive_index != 1.0)
        return torch.where(obj_type == ELLIPSOID, in_e, (obj_type == CUBOID) & in_c) & live[None]


def _sum_in_row_order(inside, ri):
    """The contained rows' RI added one row at a time in ascending row order,
    as the kernel adds it (one reduction over the rows differs in the last
    bits where a point lies in three or more rows), and their count -> (acc,
    cnt), in ``ri``'s dtype.  No host read, so a band runs the same on the
    CPU as in a captured graph."""
    vals = torch.where(inside, ri[None], torch.zeros((), dtype=ri.dtype, device=ri.device))
    acc = torch.zeros(inside.shape[0], dtype=ri.dtype, device=ri.device)
    for col in vals.t().contiguous():
        acc = acc + col
    return acc, torch.sum(inside, dim=1, dtype=torch.int32)


def ri_sum_plain(inputs):
    """The forward by the plain version: (ri (S,): the mean RI of the live
    rows (valid, RI not 1) that contain each point where their sum exceeds 1,
    else 1, as ``ops.intersect.surrounding_refractive_index`` computes it;
    den (S,) int32: each point's count where its sum exceeded 1, else 0).
    ``inputs``: ``(point, time_ratio, *FIELDS)``."""
    with torch.no_grad():
        acc, cnt = _sum_in_row_order(_inside(*inputs), inputs[-1])
        over = acc > 1.0
        return (torch.where(over, acc / torch.clamp_min(cnt.to(acc.dtype), 1.0),
                            torch.ones_like(acc)),
                torch.where(over, cnt, torch.zeros_like(cnt)))


def ri_sum_grad_plain(inputs, den, g):
    """The backward by the plain version: (N,) the gradient with respect to
    the rows' RI of the forward's output, given its gradient ``g`` (S,) and
    the forward's ``den``: each point whose sum exceeded 1 gives g / den to
    every row that contains it."""
    inside = _inside(*inputs)
    v = torch.where(den > 0, g / torch.clamp_min(den, 1).to(g.dtype), torch.zeros_like(g))
    return torch.sum(torch.where(inside, v[:, None], torch.zeros_like(v)[:, None]), dim=0)


def _check(name, t, dtype, shape, dev):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != dev
            or not t.is_contiguous()):
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device} (contiguous: "
                         f"{t.is_contiguous()}), expected {dtype} {tuple(shape)}, contiguous "
                         f"on {dev}")


def _checked(inputs):
    """The kernels' arguments from ``inputs`` (checked) -> (pointers, S, N)."""
    point, time_ratio, position, delta, rotation, scale, obj_type, valid, ri = inputs
    dev = point.device
    S, N = point.shape[0], position.shape[0]
    f = torch.float32
    for name, t, dtype, shape in (
            ("point", point, f, (S, 3)), ("time_ratio", time_ratio, f, (S,)),
            ("position", position, f, (N, 3)), ("delta_position", delta, f, (N, 3)),
            ("rotation", rotation, f, (N, 3, 3)), ("scale", scale, f, (N, 3)),
            ("obj_type", obj_type, torch.int32, (N,)), ("valid", valid, torch.bool, (N,)),
            ("refractive_index", ri, f, (N,))):
        _check(name, t, dtype, shape, dev)
    _build.check_device(dev)
    return [t.data_ptr() for t in inputs], S, N


def _split(S: int, device) -> int:
    """Lanes a point: ``sweep.nearest_ri_split`` on the card, 1 in the host
    rehearsal (whose warp is one lane)."""
    return nearest_ri_split(S) if device.type == "cuda" else 1


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# each entry point's arguments after the nine inputs' pointers
_TAIL = {"rt_ri_sum": [_LL, _I, _I, _P, _P, _P],
         "rt_ri_sum_grad": [_LL, _I, _I, _P, _P, _LL, _P, _P, _P],
         "rt_ri_sum_jvp": [_LL, _I, _I, _P, _P, _P, _P]}


def _fn(name: str):
    fn = getattr(_build.load("ri_sum"), name)
    if fn.argtypes is None:
        fn.argtypes = [_P] * 9 + _TAIL[name]
        fn.restype = ctypes.c_int
    return fn


def _launch_ri_sum(inputs):
    """Check the arguments and launch ``rt_ri_sum`` on the current stream ->
    (ri (S,) float32, den (S,) int32)."""
    ptrs, S, N = _checked(inputs)
    dev = inputs[0].device
    ri = torch.empty((S,), dtype=torch.float32, device=dev)
    den = torch.empty((S,), dtype=torch.int32, device=dev)
    code = _fn("rt_ri_sum")(*ptrs, S, N, _split(S, dev), ri.data_ptr(), den.data_ptr(),
                                _build.stream_of(dev))
    _build.check(code, "rt_ri_sum")
    if S:
        _build.LAUNCHES["ri_sum"] += 1
    return ri, den


def _launch_ri_sum_grad(inputs, den, g, smem_budget: int = SMEM_BUDGET):
    """Check the arguments and launch ``rt_ri_sum_grad`` on the current
    stream -> (grad (N,) float32, the mode: "tile" or "global")."""
    ptrs, S, N = _checked(inputs)
    dev = inputs[0].device
    _check("den", den, torch.int32, (S,), dev)
    _check("g", g, torch.float32, (S,), dev)
    if smem_budget > MAX_SMEM_BUDGET:
        raise ValueError(f"smem_budget {smem_budget} above {MAX_SMEM_BUDGET} bytes")
    grad = torch.zeros((N,), dtype=torch.float32, device=dev)
    mode = ctypes.c_int(-1)
    code = _fn("rt_ri_sum_grad")(*ptrs, S, N, _split(S, dev), g.data_ptr(), den.data_ptr(),
                                     smem_budget, ctypes.byref(mode), grad.data_ptr(),
                                     _build.stream_of(dev))
    _build.check(code, "rt_ri_sum_grad")
    if S and N:
        _build.LAUNCHES["ri_sum_grad"] += 1
    return grad, "tile" if mode.value == 1 else "global"


def _launch_ri_sum_jvp(inputs, den, tangent):
    """Check the arguments and launch ``rt_ri_sum_jvp`` on the current
    stream -> the output's tangent (S,) float32 for the rows' RI tangent
    ``tangent`` (N,)."""
    ptrs, S, N = _checked(inputs)
    dev = inputs[0].device
    _check("den", den, torch.int32, (S,), dev)
    _check("tangent", tangent, torch.float32, (N,), dev)
    out = torch.empty((S,), dtype=torch.float32, device=dev)
    code = _fn("rt_ri_sum_jvp")(*ptrs, S, N, _split(S, dev), tangent.data_ptr(), den.data_ptr(),
                                out.data_ptr(), _build.stream_of(dev))
    _build.check(code, "rt_ri_sum_jvp")
    if S:
        _build.LAUNCHES["ri_sum_jvp"] += 1
    return out


def _ri_sum(inputs):
    """The forward: the plain version for CPU tensors, else the kernel."""
    if inputs[0].device.type == "cpu":
        return ri_sum_plain(inputs)
    return _launch_ri_sum(inputs)


def _ri_sum_grad(inputs, den, g):
    """The backward: the plain version for CPU tensors, else the kernel."""
    if inputs[0].device.type == "cpu":
        return ri_sum_grad_plain(inputs, den, g)
    return _ri_sum_grad_kernel(inputs, den, g)


def _ri_sum_grad_kernel(inputs, den, g):
    """``_launch_ri_sum_grad`` on the tensors themselves under ``torch.func``
    (``_build.constant``), as ``_ri_sum_jvp_kernel`` launches its kernel."""
    return _build.constant(lambda *x: _launch_ri_sum_grad(x[:-2], x[-2], x[-1])[0],
                           *inputs, den, g)


def ri_sum_jvp_plain(inputs, den, tangent):
    """The tangent by the plain version: (S,) the output's tangent for the
    rows' RI tangent ``tangent`` (N,), given the forward's ``den``: the
    contained rows' tangents added in row order (as the kernel adds them)
    over ``den`` where it is above 0, else 0."""
    acc, _ = _sum_in_row_order(_inside(*inputs), tangent)
    return torch.where(den > 0, acc / torch.clamp_min(den, 1).to(acc.dtype),
                       torch.zeros((), dtype=acc.dtype, device=acc.device))


def _ri_sum_jvp(inputs, den, tangent):
    """The tangent: the plain version for CPU tensors, else the kernel."""
    if inputs[0].device.type == "cpu":
        return ri_sum_jvp_plain(inputs, den, tangent)
    return _ri_sum_jvp_kernel(inputs, den, tangent)


def _ri_sum_jvp_kernel(inputs, den, tangent):
    return _build.constant(lambda *x: _launch_ri_sum_jvp(x[:-2], x[-2], x[-1]),
                           *inputs, den, tangent)


class _ContainmentRI(torch.autograd.Function):
    @staticmethod
    def forward(*inputs):
        return _ri_sum(inputs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        den = output[1]
        ctx.mark_non_differentiable(den)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs, den)
        ctx.save_for_forward(*inputs, den)

    @staticmethod
    def backward(ctx, g, _):
        nones = [None] * len(ctx.needs_input_grad)
        if g is None or not ctx.needs_input_grad[-1]:
            return tuple(nones)
        *inputs, den = ctx.saved_tensors
        return (*nones[:-1], _ri_sum_grad(inputs, den, g.contiguous()))

    @staticmethod
    def jvp(ctx, *tangents):
        *inputs, den = ctx.saved_tensors
        t = tangents[-1]
        if t is None:
            return torch.zeros(den.shape, dtype=inputs[-1].dtype, device=den.device), None
        return _ri_sum_jvp(inputs, den, t.contiguous()), None


def containment_ri(scene, point, time_ratio):
    """The mean RI of the live rows of ``scene`` (valid, RI not 1) that
    contain each point (``point`` (S, 3), ``time_ratio`` (S,)) where their sum
    exceeds 1, else 1 -> (S,): ``ops.intersect.surrounding_refractive_index``.

    Differentiable with respect to ``scene.refractive_index`` alone (every
    other input gets no gradient, as containment is a boolean): the backward
    adds each point's gradient over its count into the rows that contain it.

    CPU tensors go through ``ri_sum_plain`` and ``ri_sum_grad_plain``; CUDA
    tensors launch the kernels of ``csrc/ri_sum.cu`` (counted as ``ri_sum``
    and ``ri_sum_grad``, and ``ri_sum_jvp`` for forward-mode AD's tangent)
    or raise.  None synchronises or reads on the host, so each can be
    captured in a CUDA graph."""
    fields = [getattr(scene, f) for f in FIELDS]
    fields[FIELDS.index("obj_type")] = fields[FIELDS.index("obj_type")].to(torch.int32)
    return _ContainmentRI.apply(point.contiguous(), time_ratio.contiguous(),
                                *(t.contiguous() for t in fields))[0]
