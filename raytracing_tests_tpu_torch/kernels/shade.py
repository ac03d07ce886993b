"""The "bvh" shading of the queue renderers (``ops.render.shade_rays``), with
a hand-written backward and tangent.

No TPU kernel stands behind this module: the JAX package computes this
shading in ``raytracing_tests_tpu/ops/render.py:410-591`` (``shade_rays``, its
"bvh" branch ``:519-591``) as plain ``jnp``, and XLA fuses it.  Its
counterpart here is three hand-written CUDA kernels (``csrc/shade.cu``), one
thread a lane: the forward (``shade_bvh``), its reverse-mode backward
(``shade_bvh_grad``), which recomputes the forward in registers from the
saved inputs, and its forward-mode tangent (``shade_bvh_jvp``).  The forward
and the tangent share one source of the math: a template on the scalar, a
float or a dual number.

``shade_bvh_plain`` is the same function in plain PyTorch, the code
``shade_rays`` ran before; its autograd is the backward's and its
``torch.func.jvp`` the tangent's plain version.  ``shade_bvh`` uses them only
for tensors that lie on the CPU; for CUDA tensors it launches the kernels or
raises.

What stays outside: the intersection, the surrounding-RI sum, the winner's
field gather, the texture lookup and the shadow sweep, which produce the
inputs; and the materials model (``ops.render._shade_materials``), which
shares the plain prelude (``prelude_plain``: the sky, the soft blend, the
emissive abort and the light factor).
"""

from __future__ import annotations

import ctypes

import torch

from raytracing_tests_tpu_torch.core import linalg, sampling
from raytracing_tests_tpu_torch.kernels import _build

# The differentiable inputs, in the kernels' order, and their widths a lane
# (soft_alpha is absent without soft edges).
FLOAT_INPUTS = (("o", 3), ("d", 3), ("contrib", 1), ("t", 1), ("normal", 3), ("sur_ri", 1),
                ("mat_color", 3), ("mat_ri", 1), ("refractivity", 1), ("reflectivity", 1),
                ("scat_rfr", 1), ("scat_rfl", 1), ("soft_alpha", 1))
# The constants of the gradient, in the kernels' order (lit and emissive are
# absent without lights).
OTHER_INPUTS = (("sample_idx", torch.float32), ("lit", torch.float32),
                ("bounced", torch.int32), ("active", torch.bool), ("hit", torch.bool),
                ("emissive", torch.bool))
# The differentiable outputs, in the kernels' order, and their widths.
FLOAT_OUTPUTS = (("add_color", 3), ("refr_o", 3), ("refr_d", 3), ("refr_contrib", 1),
                 ("refl_o", 3), ("refl_d", 3), ("refl_contrib", 1), ("hit_t", 1))
# The masks, in the kernels' order.
MASKS = ("set_white", "did_hit", "missed", "refr_mask", "refl_mask")
# The float inputs each float output depends on (the masks and lit are
# constants; with lights the sky is black and add_color does not read d):
# the backward gives an input a gradient only where an output that depends
# on it has one, as autograd of the plain version does (``reached``).  So a
# band's last pop, whose children no pop reads, passes none to the hit's t
# and normal, and the recompute's backward does not run for it.
DEPENDS = {"add_color": {"d", "contrib", "soft_alpha", "mat_color", "refractivity",
                         "reflectivity"},
           "refr_o": {"o", "t", "d", "normal"}, "refl_o": {"o", "t", "d", "normal"},
           "refr_d": {"d", "normal", "sur_ri", "mat_ri", "scat_rfr"},
           "refl_d": {"d", "normal", "scat_rfl"},
           "refr_contrib": {"contrib", "soft_alpha", "refractivity"},
           "refl_contrib": {"contrib", "soft_alpha", "reflectivity"}, "hit_t": {"t"}}
# What ``shade_bvh`` returns, in ``ops.render.ShadeResult``'s order (its
# media are air under this model and stay outside).
OUTPUTS = ("add_color", "set_white", "hit_t", "did_hit", "missed", "refr_mask", "refr_o",
           "refr_d", "refr_contrib", "refl_mask", "refl_o", "refl_d", "refl_contrib", "bounced")
N_FLOAT = len(FLOAT_INPUTS)


def background_plain(direction, background, has_lights: bool):
    """The sky gradient ``background`` = (bottom, top) by the ray's y; black
    when the scene has lights."""
    if has_lights:
        return torch.zeros(direction.shape[:-1] + (3,), dtype=torch.float32,
                           device=direction.device)
    bottom = linalg.const(background[0], direction)
    top = linalg.const(background[1], direction)
    t = (direction[..., 1:2] + 1.0) * 0.5
    return (1.0 - t) * bottom + t * top


def prelude_plain(d, contrib, active, hit, soft_alpha, emissive, lit, background):
    """What every shading model does first -> (did_hit, missed, add_color,
    contrib, set_white): the sky where an active lane missed; with
    ``soft_alpha`` the edge-aware blend (the lane covers its candidate with
    weight alpha and lets 1 - alpha of the sky through; the hit subtree
    scales by alpha through the contribution); with lights (``lit`` given)
    the emissive abort (the sample becomes white) and the share of lights
    the hit sees scaling the contribution."""
    did_hit = hit & active
    missed = active & ~hit
    bg = background_plain(d, background, lit is not None)
    add_color = torch.where(missed[:, None], contrib[:, None] * bg, torch.zeros_like(bg))
    if soft_alpha is not None:
        add_color = add_color + torch.where(
            did_hit[:, None], (contrib * (1.0 - soft_alpha))[:, None] * bg,
            torch.zeros_like(bg))
        contrib = torch.where(did_hit, contrib * soft_alpha, contrib)
    set_white = torch.zeros(d.shape[0], dtype=torch.bool, device=d.device)
    if lit is not None:
        set_white = did_hit & emissive
        did_hit = did_hit & ~set_white
        contrib = torch.where(did_hit, contrib * lit, contrib)
    return did_hit, missed, add_color, contrib, set_white


def shade_bvh_plain(o, d, contrib, t, normal, sur_ri, mat_color, mat_ri, refractivity,
                    reflectivity, scat_rfr, scat_rfl, soft_alpha, sample_idx, lit, bounced,
                    active, hit, emissive, *, spp: int, max_bounces: int, t_max: float,
                    background):
    """The "bvh" shading of a batch of B lanes in plain PyTorch -> the
    ``OUTPUTS``: the local term to accumulate (``add_color``), the emissive
    abort, the hit distance (``t_max`` on a miss), the masks, the two
    children (refraction first: origin 1e-4 either side of the surface,
    direction, undamped contribution) and ``bounced + 1``.

    The popped rays (``o``, ``d`` (B, 3), ``contrib``, ``bounced``,
    ``active``, ``sample_idx``), their hits (``hit``, ``t``, ``normal``), the
    surrounding RI, the winner's material (``mat_color`` (B, 3), ``mat_ri``,
    ``refractivity``, ``reflectivity``, ``scat_rfr``, ``scat_rfl``), the soft
    coverage (None with hard edges) and, with lights, ``emissive`` and
    ``lit`` (None without).  The In-Next-Week model: an outer hit spawns the
    scatter-deviated mirror and refraction (the surrounding over the
    material RI), an inner hit the refraction out (material over
    surrounding) or, on total internal reflection, the mirror; children
    inherit the undamped contribution, and the node's own term is damped by
    half of what it forwarded."""
    did_hit, missed, add_color, contrib, set_white = prelude_plain(
        d, contrib, active, hit, soft_alpha, emissive, lit, background)
    hit_point = o + t[:, None] * d
    inner = linalg.dot(normal, d) > 0.0
    bounced = bounced + 1
    can_spawn = (
        ((reflectivity > 0.002) | (refractivity > 0.002))
        & (contrib > 0.01)
        & (bounced < max_bounces)
        & did_hit
    )

    # Outer hit: scatter-deviated reflect/refract.
    refl_outer = linalg.normalize(linalg.reflect(d, normal), eps=1e-20)
    refl_outer = torch.where(
        (scat_rfl > 0.001)[:, None],
        sampling.deviate_within_cone(refl_outer, sample_idx, spp, scat_rfl),
        refl_outer,
    )
    refr_outer = linalg.safe_normalize(linalg.refract(d, normal, sur_ri / mat_ri))
    # TIR lanes carry a zero refr_outer; deviate a safe stand-in instead.
    refr_live = (linalg.dot(refr_outer, refr_outer) > 0.1)[:, None]
    unit_z = linalg.const((0.0, 0.0, 1.0), d)
    refr_safe = torch.where(refr_live, refr_outer, unit_z)
    refr_outer = torch.where(
        (scat_rfr > 0.001)[:, None] & refr_live,
        sampling.deviate_within_cone(refr_safe, sample_idx, spp, scat_rfr),
        refr_outer,
    )
    zero3 = torch.zeros_like(refl_outer)
    refl_outer = torch.where((reflectivity > 0.002)[:, None], refl_outer, zero3)
    refr_outer = torch.where((refractivity > 0.002)[:, None], refr_outer, zero3)

    # Inner hit: flip normal, 100% refract, reflect on TIR.
    n_in = -normal
    refr_inner = linalg.refract(d, n_in, mat_ri / sur_ri)
    tir = linalg.dot(refr_inner, refr_inner) < 0.1
    refl_inner = torch.where(tir[:, None], linalg.reflect(d, n_in), zero3)

    normal_out = torch.where(inner[:, None], n_in, normal)
    refl_dir = torch.where(inner[:, None], refl_inner, refl_outer)
    refr_dir = torch.where(inner[:, None], refr_inner, refr_outer)

    spawn_refr = can_spawn & (linalg.dot(refr_dir, refr_dir) > 0.1)
    spawn_refl = can_spawn & (linalg.dot(refl_dir, refl_dir) > 0.1)

    # Children inherit the UNDAMPED contribution (pushed before damping); the
    # parent's own absorption term is then damped by half of what was forwarded.
    refr_contrib = contrib * refractivity
    refl_contrib = contrib * reflectivity
    zero = torch.zeros_like(contrib)
    forward = (
        torch.where(spawn_refr, refractivity, zero) + torch.where(spawn_refl, reflectivity, zero)
    )
    contrib = contrib * (1.0 - 0.5 * forward)
    add_color = add_color + torch.where(
        did_hit[:, None], contrib[:, None] * mat_color, torch.zeros_like(mat_color))

    return (add_color, set_white, torch.where(hit, t, torch.full_like(t, t_max)), did_hit, missed,
            spawn_refr, hit_point - 1e-4 * normal_out, refr_dir, refr_contrib, spawn_refl,
            hit_point + 1e-4 * normal_out, refl_dir, refl_contrib, bounced)


# ``OUTPUTS``' float ones, by position
_FLOAT_AT = tuple(OUTPUTS.index(n) for n, _ in FLOAT_OUTPUTS)


def reached(outputs, lights: bool) -> set:
    """The float inputs that the float ``outputs`` (names) depend on."""
    got = set()
    for name in outputs:
        got |= DEPENDS[name] - ({"d"} if name == "add_color" and lights else set())
    return got


def _plain_of(inputs, statics):
    """``shade_bvh_plain`` of the float inputs alone (the constants held),
    its float outputs as a tuple (``FLOAT_OUTPUTS``' order), and the float
    inputs present (soft_alpha only with soft edges)."""
    xs, others = inputs[:N_FLOAT], inputs[N_FLOAT:]
    soft = xs[-1] is not None
    spp, max_bounces, t_max, background = statics

    def fn(*fs):
        full = tuple(fs) + ((None,) if not soft else ())
        out = shade_bvh_plain(*full, *others, spp=spp, max_bounces=max_bounces, t_max=t_max,
                              background=background)
        return tuple(out[k] for k in _FLOAT_AT)

    return fn, [x for x in xs if x is not None]


def _shade_plain(inputs, statics):
    spp, max_bounces, t_max, background = statics
    with torch.no_grad():
        return shade_bvh_plain(*inputs, spp=spp, max_bounces=max_bounces, t_max=t_max,
                               background=background)


def _shade_grad_plain(inputs, grads, statics):
    """The backward by the plain version: the VJP of its autograd -> one
    gradient a float input (None for an absent soft_alpha)."""
    fn, xs = _plain_of(inputs, statics)
    out, vjp = torch.func.vjp(fn, *xs)
    got = vjp(tuple(torch.zeros_like(v) if g is None else g for v, g in zip(out, grads)))
    return list(got) + [None] * (N_FLOAT - len(got))


def _shade_jvp_plain(inputs, tangents, statics):
    """The tangent by the plain version: ``torch.func.jvp`` of it, one
    tangent a float input (None: zero, and for an absent soft_alpha) -> the
    float outputs' tangents."""
    fn, xs = _plain_of(inputs, statics)
    tans = tuple(torch.zeros_like(x) if t is None else t
                 for x, t in zip(inputs[:N_FLOAT], tangents) if x is not None)
    return torch.func.jvp(fn, tuple(xs), tans)[1]


def _check(name, t, dtype, shape, dev):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != dev
            or not t.is_contiguous()):
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device} (contiguous: "
                         f"{t.is_contiguous()}), expected {dtype} {tuple(shape)}, contiguous "
                         f"on {dev}")


def _shape(B: int, width: int):
    return (B, width) if width > 1 else (B,)


def _checked(inputs):
    """The kernels' input arguments from ``inputs`` (checked) -> (float
    pointers, other pointers, B)."""
    if len(inputs) != N_FLOAT + len(OTHER_INPUTS):
        raise ValueError(f"{len(inputs)} inputs, expected {N_FLOAT + len(OTHER_INPUTS)}")
    o = inputs[0]
    dev, B = o.device, o.shape[0]
    for (name, w), x in zip(FLOAT_INPUTS, inputs):
        if x is not None or name != "soft_alpha":
            _check(name, x, torch.float32, _shape(B, w), dev)
    others = inputs[N_FLOAT:]
    lights = others[1] is not None
    if (others[5] is not None) != lights:
        raise ValueError("lit and emissive: both with lights, neither without")
    for (name, dtype), x in zip(OTHER_INPUTS, others):
        if x is not None:
            _check(name, x, dtype, (B,), dev)
    _build.check_device(dev)
    return _pointers(inputs[:N_FLOAT]), _pointers(others), B


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr()
                                              for t in tensors])


def _statics_args(statics):
    """(ints: spp, max_bounces; floats: t_max, the sky's bottom and top) as
    host arrays."""
    spp, max_bounces, t_max, background = statics
    ints = (ctypes.c_int * 2)(int(spp), int(max_bounces))
    floats = (ctypes.c_float * 7)(float(t_max), *map(float, background[0]),
                                  *map(float, background[1]))
    return ints, floats


_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_ARGS = {"rt_shade_bvh": [_P, _P, _P, _P, _P, _LL, _P, _P, _P],
         "rt_shade_bvh_jvp": [_P, _P, _P, _P, _LL, _P, _P, _P],
         "rt_shade_bvh_grad": [_P, _P, _P, _P, _LL, _P, _P, _P]}


def _fn(name: str):
    fn = getattr(_build.load("shade"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGS[name]
        fn.restype = ctypes.c_int
    return fn


def _float_outputs(B: int, dev):
    return [torch.empty(_shape(B, w), dtype=torch.float32, device=dev) for _, w in FLOAT_OUTPUTS]


def _launch_shade(inputs, statics):
    """Check the arguments and launch ``rt_shade_bvh`` on the current stream
    -> the ``OUTPUTS``."""
    fin, other, B = _checked(inputs)
    dev = inputs[0].device
    outs = _float_outputs(B, dev)
    masks = [torch.empty(B, dtype=torch.bool, device=dev) for _ in MASKS]
    bounced = torch.empty(B, dtype=torch.int32, device=dev)
    ints, floats = _statics_args(statics)
    code = _fn("rt_shade_bvh")(fin, other, _pointers(outs), _pointers(masks),
                               bounced.data_ptr(), B, ints, floats, _build.stream_of(dev))
    _build.check(code, "rt_shade_bvh")
    if B:
        _build.LAUNCHES["shade_bvh"] += 1
    got = dict(zip([n for n, _ in FLOAT_OUTPUTS], outs), **dict(zip(MASKS, masks)),
               bounced=bounced)
    return tuple(got[n] for n in OUTPUTS)


def _launch_shade_jvp(inputs, tangents, statics):
    """Check the arguments and launch ``rt_shade_bvh_jvp`` on the current
    stream: ``tangents`` one a float input (its shape; None: zero) -> the
    float outputs' tangents (``FLOAT_OUTPUTS``' order)."""
    fin, other, B = _checked(inputs)
    dev = inputs[0].device
    if len(tangents) != N_FLOAT:
        raise ValueError(f"{len(tangents)} tangents for {N_FLOAT} inputs")
    for (name, w), t in zip(FLOAT_INPUTS, tangents):
        if t is not None:
            _check(f"tangent of {name}", t, torch.float32, _shape(B, w), dev)
    outs = _float_outputs(B, dev)
    ints, floats = _statics_args(statics)
    code = _fn("rt_shade_bvh_jvp")(fin, other, _pointers(list(tangents)), _pointers(outs), B,
                                   ints, floats, _build.stream_of(dev))
    _build.check(code, "rt_shade_bvh_jvp")
    if B:
        _build.LAUNCHES["shade_bvh_jvp"] += 1
    return tuple(outs)


def _launch_shade_grad(inputs, grads, statics, need=None):
    """Check the arguments and launch ``rt_shade_bvh_grad`` on the current
    stream: ``grads`` one a float output (its shape; None: zero), ``need``
    one bool a float input (None: every present one) -> the float inputs'
    gradients (None where not needed or absent)."""
    fin, other, B = _checked(inputs)
    dev = inputs[0].device
    if len(grads) != len(FLOAT_OUTPUTS):
        raise ValueError(f"{len(grads)} gradients for {len(FLOAT_OUTPUTS)} outputs")
    for (name, w), g in zip(FLOAT_OUTPUTS, grads):
        if g is not None:
            _check(f"gradient of {name}", g, torch.float32, _shape(B, w), dev)
    need = [True] * N_FLOAT if need is None else list(need)
    outs = [torch.empty(_shape(B, w), dtype=torch.float32, device=dev)
            if n and x is not None else None
            for (_, w), n, x in zip(FLOAT_INPUTS, need, inputs[:N_FLOAT])]
    ints, floats = _statics_args(statics)
    code = _fn("rt_shade_bvh_grad")(fin, other, _pointers(list(grads)), _pointers(outs), B,
                                    ints, floats, _build.stream_of(dev))
    _build.check(code, "rt_shade_bvh_grad")
    if B:
        _build.LAUNCHES["shade_bvh_grad"] += 1
    return outs


def _shade(inputs, statics):
    """The forward: the plain version for CPU tensors, else the kernel."""
    if inputs[0].device.type == "cpu":
        return _shade_plain(inputs, statics)
    return _launch_shade(inputs, statics)


def _shade_grad(inputs, grads, statics, need):
    """The backward: the plain version for CPU tensors, else the kernel."""
    if inputs[0].device.type == "cpu":
        got = _shade_grad_plain(inputs, grads, statics)
        return [g if n else None for g, n in zip(got, need)]
    return _shade_grad_kernel(inputs, grads, statics, need)


def _shade_grad_kernel(inputs, grads, statics, need):
    """``_launch_shade_grad`` on the tensors themselves under ``torch.func``
    (``_build.constant``)."""
    present, back = _build.given(list(inputs) + list(grads))
    n_in = len(inputs)
    wanted = [n and x is not None for n, x in zip(need, inputs[:N_FLOAT])]

    def launch(*x):
        full = back(x)
        got = _launch_shade_grad(full[:n_in], full[n_in:], statics, wanted)
        return tuple(g for g in got if g is not None)

    got = iter(_build.constant(launch, *present) if any(wanted) else ())
    return [next(got) if w else None for w in wanted]


def _shade_jvp(inputs, tangents, statics):
    """The tangent: the plain version for CPU tensors, else the kernel."""
    if inputs[0].device.type == "cpu":
        return _shade_jvp_plain(inputs, tangents, statics)
    return _shade_jvp_kernel(inputs, tangents, statics)


def _shade_jvp_kernel(inputs, tangents, statics):
    present, back = _build.given(list(inputs) + list(tangents))
    n_in = len(inputs)

    def launch(*x):
        full = back(x)
        return _launch_shade_jvp(full[:n_in], full[n_in:], statics)

    return _build.constant(launch, *present)


class _ShadeBvh(torch.autograd.Function):
    @staticmethod
    def forward(o, d, contrib, t, normal, sur_ri, mat_color, mat_ri, refractivity, reflectivity,
                scat_rfr, scat_rfl, soft_alpha, sample_idx, lit, bounced, active, hit, emissive,
                statics):
        return _shade((o, d, contrib, t, normal, sur_ri, mat_color, mat_ri, refractivity,
                       reflectivity, scat_rfr, scat_rfl, soft_alpha, sample_idx, lit, bounced,
                       active, hit, emissive), statics)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.statics = inputs[-1]
        ctx.present = [x is not None for x in inputs[:-1]]
        saved = [x for x in inputs[:-1] if x is not None]
        ctx.save_for_backward(*saved)
        ctx.save_for_forward(*saved)
        ctx.mark_non_differentiable(*[output[OUTPUTS.index(n)] for n in MASKS + ("bounced",)])
        ctx.set_materialize_grads(False)

    @staticmethod
    def _inputs(ctx):
        it = iter(ctx.saved_tensors)
        return [next(it) if p else None for p in ctx.present]

    @staticmethod
    def backward(ctx, *grads):
        out = [None] * (len(ctx.present) + 1)
        grads = [grads[k] for k in _FLOAT_AT]
        reach = reached([n for (n, _), g in zip(FLOAT_OUTPUTS, grads) if g is not None],
                        lights=ctx.present[N_FLOAT + 1])
        need = [n and name in reach
                for n, (name, _) in zip(ctx.needs_input_grad[:N_FLOAT], FLOAT_INPUTS)]
        if not any(need) or all(g is None for g in grads):
            return tuple(out)
        grads = [None if g is None else g.contiguous() for g in grads]
        got = _shade_grad(_ShadeBvh._inputs(ctx), grads, ctx.statics, need)
        out[:N_FLOAT] = got
        return tuple(out)

    @staticmethod
    def jvp(ctx, *tangents):
        inputs = _ShadeBvh._inputs(ctx)
        tans = [None if t is None or x is None else t.contiguous()
                for t, x in zip(tangents[:N_FLOAT], inputs)]
        got = _shade_jvp(inputs, tans, ctx.statics)
        out = [None] * len(OUTPUTS)
        for k, g in zip(_FLOAT_AT, got):
            out[k] = g
        return tuple(out)


def shade_bvh(o, d, contrib, t, normal, sur_ri, mat_color, mat_ri, refractivity, reflectivity,
              scat_rfr, scat_rfl, soft_alpha, sample_idx, lit, bounced, active, hit, emissive,
              *, spp: int, max_bounces: int, t_max: float, background):
    """``shade_bvh_plain`` (its arguments and ``OUTPUTS``), differentiable
    with respect to the float inputs in reverse and in forward mode
    (``torch.func``); the masks, ``bounced``, ``sample_idx``, ``lit`` and
    ``emissive`` are constants of the gradient.  CPU tensors go through
    ``shade_bvh_plain`` (its autograd for the backward, ``torch.func.jvp``
    of it for the tangent); CUDA tensors launch the kernels of
    ``csrc/shade.cu`` (counted as ``shade_bvh``, ``shade_bvh_grad`` and
    ``shade_bvh_jvp``) or raise.  None synchronises or reads on the host,
    so each can be captured in a CUDA graph."""
    if (lit is None) != (emissive is None):
        raise ValueError("lit and emissive: both with lights, neither without")
    c = lambda x: None if x is None else x.contiguous()  # noqa: E731
    background = tuple(tuple(float(v) for v in c) for c in background)
    if len(background) != 2 or any(len(c) != 3 for c in background):
        raise ValueError(f"background {background}: expected (bottom, top) colours")
    statics = (int(spp), int(max_bounces), float(t_max), background)
    return _ShadeBvh.apply(
        c(o), c(d), c(contrib), c(t), c(normal), c(sur_ri), c(mat_color), c(mat_ri),
        c(refractivity), c(reflectivity), c(scat_rfr), c(scat_rfl), c(soft_alpha),
        c(sample_idx), c(lit), bounced.to(torch.int32).contiguous(),
        active.to(torch.bool).contiguous(), hit.to(torch.bool).contiguous(),
        None if emissive is None else emissive.to(torch.bool).contiguous(), statics)
