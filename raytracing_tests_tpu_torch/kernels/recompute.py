"""The gradient path's closed-form recompute of each lane's hit on its winner,
with a hand-written backward and tangent.

No TPU kernel stands behind this module: the JAX package's differentiable
recompute (``raytracing_tests_tpu/diff/fastpath.py:141-210``, after the
winner's gathers) is elementwise per lane, and XLA fuses it.  Its
counterpart here is three hand-written CUDA kernels (``csrc/recompute.cu``),
one thread a lane: the forward (``winner_recompute``), its reverse-mode
backward (``winner_recompute_grad``), which recomputes the forward in
registers from the saved inputs, and its forward-mode tangent
(``winner_recompute_jvp``).  The three share one source of the math: a
template on the scalar, a float or a dual number.

``winner_recompute_plain`` is the same function in plain PyTorch, the code
``diff.fastpath.intersect_diff`` ran before; its autograd is the backward's
and its ``torch.func.jvp`` the tangent's plain version.  ``winner_recompute``
uses them only for tensors that lie on the CPU; for CUDA tensors it launches
the kernels or raises.

A finding about the reference, kept here: the soft estimator's
``real = t < 2.9e38`` is always true, since both packages' ``MISS_T`` is -1
(``core.geometry.MISS_T``), so a near-miss lane keeps t = -1 and never takes
``t_cl``.  The kernels keep that behaviour.
"""

from __future__ import annotations

import ctypes

import torch

from raytracing_tests_tpu_torch.core import geometry, linalg
from raytracing_tests_tpu_torch.kernels import _build

MODES = ("spheres", "generic")
# The differentiable inputs, in the kernels' order, and their widths a lane.
FLOAT_INPUTS = (("o", 3), ("d", 3), ("time_ratio", 1), ("position", 3), ("delta_position", 3),
                ("rotation", 9), ("scale", 3))
# The outputs, in the kernels' order: t, normal, local_pos, alpha.
OUTPUT_WIDTHS = (1, 3, 3, 1)
# Where the float inputs stand among ``winner_recompute``'s positional ones
# (hit after time_ratio, obj_type last).
_AT = (0, 1, 2, 4, 5, 6, 7)


def _clamp(x, lo: float):
    """max(x, lo) whose gradient splits 1/2 : 1/2 at a tie, as the JAX
    package's ``jnp.maximum`` does (``clamp_min`` passes all of it)."""
    return torch.maximum(x, torch.full((), lo, dtype=x.dtype, device=x.device))


def winner_recompute_plain(o, d, time_ratio, hit, position, delta_position, rotation, scale,
                           obj_type, *, soft: float, mode: str):
    """The recompute in plain PyTorch -> (t (B,), normal (B, 3), local_pos
    (B, 3), alpha (B,) or None where ``soft`` is 0): the winner's hit with the
    dense intersector's own math (the same rotation and per-axis-scale
    frame), so its gradients are the dense path's.

    ``soft > 0`` gives every lane a smooth coverage ``alpha`` of its
    candidate.  Sphere mode (``mode == "spheres"``):
    sigmoid(-(h - r) / (soft * t)) with h the world distance from the ray's
    line to the centre.  Generic mode: the same blend in the object's local
    unit frame (rotate by R^T, divide by scale; ellipsoid silhouette at
    |q| = 1, cuboid at Chebyshev distance 0.5 of the closest-approach point
    q), rescaled to world units by the geometric-mean scale."""
    rot, otype = rotation.reshape(-1, 3, 3), obj_type
    rel = o - position + (1.0 - time_ratio)[:, None] * delta_position
    lo = linalg.apply_rotation_t(rot, rel)
    ld = linalg.apply_rotation_t(rot, d)
    t = geometry.ray_primitive_t(lo, ld, scale, otype)

    alpha = None
    if soft > 0.0:
        if mode == "spheres":
            # Isotropic coverage: h = distance from the centre to the ray's
            # line at the closest-approach point t_cl (ahead of the ray, by
            # the kernel's forward filter); smooth on both sides.
            a = _clamp(torch.sum(d * d, dim=1), 1e-20)
            half_b = torch.sum(rel * d, dim=1)
            t_cl = -half_b / a
            h2 = torch.sum(rel * rel, dim=1) - half_b * half_b / a
            h = torch.sqrt(_clamp(h2, 1e-20))
            band = soft * _clamp(torch.abs(t_cl), 1e-3)
            alpha = torch.sigmoid(-(h - scale[:, 0]) / band)
        else:
            # Rotated-frame coverage: the closest approach of the ray to the
            # object in its LOCAL UNIT space (the ellipsoid is the unit
            # sphere, the cuboid the unit cube); the silhouette distance is
            # |q| - 1 (ellipsoid) or twice the Chebyshev max|q| - 0.5
            # (cuboid), in world units by the geometric-mean scale.
            ssafe = _clamp(scale, 1e-20)
            lo_s = lo / ssafe
            ld_s = ld / ssafe
            a = _clamp(torch.sum(ld_s * ld_s, dim=1), 1e-20)
            half_b = torch.sum(lo_s * ld_s, dim=1)
            t_cl = -half_b / a  # the world ray parameter (the same t in either frame)
            q = lo_s + t_cl[:, None] * ld_s
            h_ell = torch.sqrt(_clamp(torch.sum(q * q, dim=1), 1e-20))
            h_cub = torch.amax(torch.abs(q), dim=1)
            is_ell = otype == geometry.ELLIPSOID
            over = torch.where(is_ell, h_ell - 1.0, 2.0 * (h_cub - 0.5))
            r_geo = torch.exp(torch.mean(torch.log(ssafe), dim=1))
            band = soft * _clamp(torch.abs(t_cl), 1e-3)
            alpha = torch.sigmoid(-(over * r_geo) / band)
        alpha = torch.where(hit, alpha, torch.zeros_like(alpha))
        # Geometric-miss lanes (adopted candidates) hit at the tangent point.
        real = t < 2.9e38
        t = torch.where(real, t, t_cl)

    t = torch.where(hit, t, torch.ones_like(t))
    p_local = lo + t[:, None] * ld
    n_local = geometry.primitive_normal(p_local, scale, otype)
    normal = linalg.apply_rotation(rot, n_local)
    local_pos = p_local / scale
    return t, normal, local_pos, alpha


def _plain_of(inputs, soft, spheres):
    """``winner_recompute_plain`` of the float inputs alone (hit and
    obj_type held), its outputs as a tuple without the absent alpha."""
    hit, otype = inputs[3], inputs[8]
    mode = MODES[0] if spheres else MODES[1]

    def fn(*xs):
        o, d, tr, pos, dpos, rot, scale = xs
        out = winner_recompute_plain(o, d, tr, hit, pos, dpos, rot, scale, otype, soft=soft,
                                     mode=mode)
        return out if soft > 0.0 else out[:3]

    return fn, [inputs[k] for k in _AT]


def _recompute_plain(inputs, soft, spheres):
    fn, xs = _plain_of(inputs, soft, spheres)
    with torch.no_grad():
        return fn(*xs)


def _recompute_grad_plain(inputs, grads, soft, spheres):
    """The backward by the plain version: the VJP of its autograd, one
    gradient a float input."""
    fn, xs = _plain_of(inputs, soft, spheres)
    out, vjp = torch.func.vjp(fn, *xs)
    return vjp(tuple(torch.zeros_like(v) if g is None else g for v, g in zip(out, grads)))


def _recompute_jvp_plain(inputs, tangents, soft, spheres):
    """The tangent by the plain version: ``torch.func.jvp`` of it."""
    fn, xs = _plain_of(inputs, soft, spheres)
    tans = tuple(torch.zeros_like(x) if t is None else t for x, t in zip(xs, tangents))
    return torch.func.jvp(fn, tuple(xs), tans)[1]


def _check(name, t, dtype, shape, dev):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != dev
            or not t.is_contiguous()):
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device} (contiguous: "
                         f"{t.is_contiguous()}), expected {dtype} {tuple(shape)}, contiguous "
                         f"on {dev}")


def _shape(B: int, width: int):
    return (B, 3, 3) if width == 9 else (B, width) if width > 1 else (B,)


def _checked(inputs):
    """The kernels' input arguments from ``inputs`` (checked) -> (float
    pointers, hit, obj_type, B)."""
    o = inputs[0]
    dev, B = o.device, o.shape[0]
    for (name, w), k in zip(FLOAT_INPUTS, _AT):
        _check(name, inputs[k], torch.float32, _shape(B, w), dev)
    _check("hit", inputs[3], torch.bool, (B,), dev)
    _check("obj_type", inputs[8], torch.int32, (B,), dev)
    _build.check_device(dev)
    return [inputs[k].data_ptr() for k in _AT], inputs[3].data_ptr(), inputs[8].data_ptr(), B


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr()
                                              for t in tensors])


_P, _LL, _F, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_int
_ARGS = {"rt_winner_recompute": [_P, _P, _P, _P, _LL, _F, _I, _P],
         "rt_winner_recompute_jvp": [_P, _P, _P, _P, _P, _LL, _F, _I, _P],
         "rt_winner_recompute_grad": [_P, _P, _P, _P, _P, _LL, _F, _I, _P]}


def _fn(name: str):
    fn = getattr(_build.load("recompute"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGS[name]
        fn.restype = ctypes.c_int
    return fn


def _outputs(B: int, soft: float, dev):
    """Empty outputs (t, normal, local_pos and, where ``soft`` > 0, alpha)."""
    widths = OUTPUT_WIDTHS if soft > 0.0 else OUTPUT_WIDTHS[:3]
    return [torch.empty(_shape(B, w), dtype=torch.float32, device=dev) for w in widths]


def _launch_recompute(inputs, soft: float, spheres: bool):
    """Check the arguments and launch ``rt_winner_recompute`` on the current
    stream -> (t, normal, local_pos[, alpha])."""
    ptrs, hit, otype, B = _checked(inputs)
    dev = inputs[0].device
    outs = _outputs(B, soft, dev)
    code = _fn("rt_winner_recompute")((_P * 7)(*ptrs), hit, otype,
                                      _pointers(outs + [None] * (4 - len(outs))), B, soft,
                                      int(spheres), _build.stream_of(dev))
    _build.check(code, "rt_winner_recompute")
    if B:
        _build.LAUNCHES["winner_recompute"] += 1
    return tuple(outs)


def _launch_recompute_jvp(inputs, tangents, soft: float, spheres: bool):
    """Check the arguments and launch ``rt_winner_recompute_jvp`` on the
    current stream: ``tangents`` one a float input (its shape; None: zero)
    -> the outputs' tangents (t, normal, local_pos[, alpha])."""
    ptrs, hit, otype, B = _checked(inputs)
    dev = inputs[0].device
    if len(tangents) != len(FLOAT_INPUTS):
        raise ValueError(f"{len(tangents)} tangents for {len(FLOAT_INPUTS)} inputs")
    for (name, w), t in zip(FLOAT_INPUTS, tangents):
        if t is not None:
            _check(f"tangent of {name}", t, torch.float32, _shape(B, w), dev)
    outs = _outputs(B, soft, dev)
    code = _fn("rt_winner_recompute_jvp")((_P * 7)(*ptrs), hit, otype, _pointers(list(tangents)),
                                          _pointers(outs + [None] * (4 - len(outs))), B, soft,
                                          int(spheres), _build.stream_of(dev))
    _build.check(code, "rt_winner_recompute_jvp")
    if B:
        _build.LAUNCHES["winner_recompute_jvp"] += 1
    return tuple(outs)


def _launch_recompute_grad(inputs, grads, soft: float, spheres: bool, need=None):
    """Check the arguments and launch ``rt_winner_recompute_grad`` on the
    current stream: ``grads`` one an output (its shape; None: zero), ``need``
    one bool a float input (None: all) -> the float inputs' gradients (None
    where not needed)."""
    ptrs, hit, otype, B = _checked(inputs)
    dev = inputs[0].device
    widths = OUTPUT_WIDTHS[:len(grads)]
    if len(grads) != (4 if soft > 0.0 else 3):
        raise ValueError(f"{len(grads)} gradients for {4 if soft > 0.0 else 3} outputs")
    for w, g in zip(widths, grads):
        if g is not None:
            _check("gradient", g, torch.float32, _shape(B, w), dev)
    need = [True] * len(FLOAT_INPUTS) if need is None else list(need)
    outs = [torch.empty(_shape(B, w), dtype=torch.float32, device=dev) if n else None
            for (_, w), n in zip(FLOAT_INPUTS, need)]
    code = _fn("rt_winner_recompute_grad")((_P * 7)(*ptrs), hit, otype,
                                           _pointers(list(grads) + [None] * (4 - len(grads))),
                                           _pointers(outs), B, soft, int(spheres),
                                           _build.stream_of(dev))
    _build.check(code, "rt_winner_recompute_grad")
    if B and any(g is not None for g in grads) and any(need):
        _build.LAUNCHES["winner_recompute_grad"] += 1
    return outs


def _recompute(inputs, soft, spheres):
    """The forward: the plain version for CPU tensors, else the kernel."""
    if inputs[0].device.type == "cpu":
        return _recompute_plain(inputs, soft, spheres)
    return _launch_recompute(inputs, soft, spheres)


def _recompute_grad(inputs, grads, soft, spheres, need):
    """The backward: the plain version for CPU tensors, else the kernel."""
    if inputs[0].device.type == "cpu":
        got = _recompute_grad_plain(inputs, grads, soft, spheres)
        return [g if n else None for g, n in zip(got, need)]
    return _recompute_grad_kernel(inputs, grads, soft, spheres, need)


def _recompute_grad_kernel(inputs, grads, soft, spheres, need):
    """``_launch_recompute_grad`` on the tensors themselves under
    ``torch.func`` (``_build.constant``), as ``_recompute_jvp_kernel``
    launches its kernel."""
    present, back = _build.given(grads)
    got = _build.constant(lambda *x: tuple(g for g in _launch_recompute_grad(
        x[:9], back(x[9:]), soft, spheres, need) if g is not None), *inputs, *present)
    it = iter(got)
    return [next(it) if n else None for n in need]


def _recompute_jvp(inputs, tangents, soft, spheres):
    """The tangent: the plain version for CPU tensors, else the kernel."""
    if inputs[0].device.type == "cpu":
        return _recompute_jvp_plain(inputs, tangents, soft, spheres)
    return _recompute_jvp_kernel(inputs, tangents, soft, spheres)


def _recompute_jvp_kernel(inputs, tangents, soft, spheres):
    present, back = _build.given(tangents)
    return _build.constant(lambda *x: _launch_recompute_jvp(x[:9], back(x[9:]), soft, spheres),
                           *inputs, *present)


class _WinnerRecompute(torch.autograd.Function):
    @staticmethod
    def forward(o, d, time_ratio, hit, position, delta_position, rotation, scale, obj_type,
                soft, spheres):
        return _recompute((o, d, time_ratio, hit, position, delta_position, rotation, scale,
                           obj_type), soft, spheres)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.soft, ctx.spheres = inputs[9], inputs[10]
        ctx.save_for_backward(*inputs[:9])
        ctx.save_for_forward(*inputs[:9])
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, *grads):
        out = [None] * 11
        need = [ctx.needs_input_grad[k] for k in _AT]
        if not any(need) or all(g is None for g in grads):
            return tuple(out)
        grads = [None if g is None else g.contiguous() for g in grads]
        got = _recompute_grad(ctx.saved_tensors, grads, ctx.soft, ctx.spheres, need)
        for k, g in zip(_AT, got):
            out[k] = g
        return tuple(out)

    @staticmethod
    def jvp(ctx, *tangents):
        tans = [None if tangents[k] is None else tangents[k].contiguous() for k in _AT]
        return tuple(_recompute_jvp(ctx.saved_tensors, tans, ctx.soft, ctx.spheres))


def winner_recompute(o, d, time_ratio, hit, position, delta_position, rotation, scale, obj_type,
                     *, soft: float, mode: str):
    """Each lane's hit on its winner, recomputed in closed form from its ray
    (``o``, ``d`` (B, 3), ``time_ratio`` (B,)), whether it hit (``hit`` (B,)
    bool) and its winner's gathered row (``position``, ``delta_position``,
    ``scale`` (B, 3), ``rotation`` (B, 3, 3), ``obj_type`` (B,)) -> (t (B,),
    normal (B, 3), local_pos (B, 3), alpha (B,) or None where ``soft`` is 0):
    ``winner_recompute_plain``, with the soft coverage of ``mode``
    ("spheres" or "generic").

    Differentiable with respect to the float inputs, in reverse and in
    forward mode (``torch.func``).  CPU tensors go through
    ``winner_recompute_plain`` (its autograd for the backward,
    ``torch.func.jvp`` of it for the tangent); CUDA tensors launch the
    kernels of ``csrc/recompute.cu`` (counted as ``winner_recompute``,
    ``winner_recompute_grad`` and ``winner_recompute_jvp``) or raise.  None
    synchronises or reads on the host, so each can be captured in a CUDA
    graph."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}, expected one of {MODES}")
    soft = float(soft)
    out = _WinnerRecompute.apply(
        o.contiguous(), d.contiguous(), time_ratio.contiguous(), hit.to(torch.bool).contiguous(),
        position.contiguous(), delta_position.contiguous(), rotation.reshape(-1, 3, 3).contiguous(),
        scale.contiguous(), obj_type.to(torch.int32).contiguous(), soft, mode == "spheres")
    return (*out[:3], out[3] if soft > 0.0 else None)
