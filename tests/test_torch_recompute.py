"""The gradient path's closed-form recompute (``kernels.recompute``).

Inputs come from a numpy seed: B lanes, each with its own winner row (one
row a lane), in sphere scenes (isotropic scale, no rotation) and generic
scenes (rotated ellipsoids and cuboids of any scale), with motion.  Among the
lanes: rays aimed at the body (hits and geometric misses, which in the soft
estimator are the near misses that adopt the candidate), rays from inside the
body, rays at an axis-aligned cube's edge (the slab's entry and the face
distances tie exactly), and lanes that hit nothing (they read row 0).

- ``winner_recompute_plain`` against the JAX package's recompute
  (``diff.fastpath.intersect_diff`` with its winner search replaced by the
  lanes' rows): the outputs, and the VJP against ``jax.vjp`` with respect to
  the rays and the rows, each field within 5e-4 of its max |value| (|g|);
  the forward on the tie lanes exactly.
- ``winner_recompute`` (the ``torch.autograd.Function``) on the CPU equals
  the plain version's outputs, autograd and ``torch.func.jvp``.
- Where there is a g++, the kernel source ``csrc/recompute.cu`` compiled as
  host C++ (``_build.host_rehearsal``): its forward within 1e-4 (abs + rel) of
  the plain version on >= 99 % of lanes' every output (the sums over three
  components run in the card's order, the host's plain version in the CPU's),
  and its backward and tangent against float64 autograd and
  ``torch.func.jvp`` of the plain version: every field's summed |error|
  within 1e-3 of its sum of |g| (float32 loses digits at grazing lanes: the
  plain version's own float32 autograd is off by some 1e-4 here, found
  4.6e-5 to 1.1e-4 for either), and the tie lanes' gradients, where the even
  split of a tie decides them, within 1e-5 of the field's max |g|.
"""

import dataclasses
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tests_tpu.diff import fastpath as jfastpath
from raytracing_tests_tpu.kernels import sweep2g as jsweep2g
from raytracing_tests_tpu.scene import types as jtypes
from raytracing_tests_tpu_torch.core import linalg
from raytracing_tests_tpu_torch.kernels import _build
from raytracing_tests_tpu_torch.kernels import recompute as rc

torch.set_num_threads(2)

B = 384
N_TIE = 16  # lanes at an axis-aligned cube's edge (generic scenes)
N_INSIDE = 32
N_MISS = 24  # lanes that hit nothing
FIELDS = ("o", "d", "time_ratio", "position", "delta_position", "rotation", "scale")
ROWS = ("position", "delta_position", "rotation", "scale")


def lanes(mode, seed=0):
    """{field: numpy array} of B lanes and their rows (one a lane), ``hit``
    and ``obj`` (the lane's row, -1 where it hit nothing), ``tie`` (the edge
    lanes)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-3.0, 3.0, (B, 3)).astype(np.float32)
    dpos = rng.uniform(-0.2, 0.2, (B, 3)).astype(np.float32)
    tr = rng.uniform(0.0, 1.0, B).astype(np.float32)
    if mode == "spheres":
        r = rng.uniform(0.3, 1.5, B).astype(np.float32)
        scale = np.stack([r, r, r], 1)
        ang = np.zeros((B, 3), np.float32)
        otype = np.full(B, 1, np.int32)
    else:
        scale = rng.uniform(0.3, 1.5, (B, 3)).astype(np.float32)
        ang = rng.uniform(-np.pi, np.pi, (B, 3)).astype(np.float32)
        otype = rng.integers(1, 3, B).astype(np.int32)
    rot = linalg.rotation_from_radians(torch.from_numpy(ang)).numpy().astype(np.float32)
    # the body's centre at the lane's time: position - (1 - tr) delta_position
    centre = pos - (1.0 - tr)[:, None] * dpos
    o = centre + rng.normal(size=(B, 3)) * 6.0
    aim = centre + rng.normal(size=(B, 3)) * 0.6 * scale
    inside = slice(0, N_INSIDE)
    o[inside] = centre[inside] + rng.uniform(-0.2, 0.2, (N_INSIDE, 3)) * scale[inside]
    aim[inside] = o[inside] + rng.normal(size=(N_INSIDE, 3))
    tie = np.zeros(B, bool)
    if mode == "generic":
        at = slice(N_INSIDE, N_INSIDE + N_TIE)
        otype[at], rot[at], dpos[at], tr[at] = 2, np.eye(3, dtype=np.float32), 0.0, 1.0
        scale[at] = 1.0
        # on a grid, so that the ray's offsets are exact and the tie is one
        # in exact arithmetic too
        pos[at] = np.round(pos[at] * 4.0) / 4.0
        z = np.round(rng.uniform(-0.3, 0.3, N_TIE) * 64.0) / 64.0
        o[at] = pos[at] + np.stack([np.full(N_TIE, -2.0), np.full(N_TIE, -2.0), z], 1)
        aim[at] = o[at] + np.array([1.0, 1.0, 0.0])
        tie[at] = True
    d = (aim - o).astype(np.float64)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hit = np.ones(B, bool)
    hit[B - N_MISS:] = False
    obj = np.where(hit, np.arange(B), -1).astype(np.int32)
    return dict(o=o.astype(np.float32), d=d.astype(np.float32), time_ratio=tr, hit=hit,
                position=pos, delta_position=dpos.astype(np.float32), rotation=rot,
                scale=scale.astype(np.float32), obj_type=otype, obj=obj, tie=tie)


def port_inputs(x, dtype=torch.float32):
    """The plain version's positional inputs: each lane's row at max(obj, 0)."""
    safe = np.maximum(x["obj"], 0)
    row = lambda f: torch.from_numpy(np.ascontiguousarray(x[f][safe])).to(dtype)  # noqa: E731
    ray = lambda f: torch.from_numpy(x[f]).to(dtype)  # noqa: E731
    return [ray("o"), ray("d"), ray("time_ratio"), torch.from_numpy(x["hit"]), row("position"),
            row("delta_position"), row("rotation"), row("scale"),
            torch.from_numpy(x["obj_type"][safe])]


def jax_recompute(x, mode, soft):
    """The JAX package's recompute of the lanes: ``intersect_diff`` over a
    scene of their rows, its winner search replaced by the lanes' rows ->
    (fn of (o, d, time_ratio, position, delta_position, rotation, scale) ->
    (t, normal, local_pos[, alpha]), its arguments)."""
    obj = jnp.asarray(x["obj"])
    found = lambda *a, **k: (None, obj, obj)  # noqa: E731
    accel = SimpleNamespace(mode=mode, inner=SimpleNamespace(perm=jnp.arange(B)))
    zeros, ones = jnp.zeros(B, jnp.float32), jnp.ones(B, jnp.float32)

    def fn(o, d, tr, position, delta_position, rotation, scale):
        scene = jtypes.Scene(
            position=position, rotation=rotation, scale=scale, delta_position=delta_position,
            obj_type=jnp.asarray(x["obj_type"]), color=jnp.zeros((B, 3)), refractive_index=ones,
            refractivity=zeros, reflectivity=zeros, scatter_refract=zeros,
            scatter_reflect=zeros, texture_index=jnp.zeros(B, jnp.int32),
            emissive=jnp.zeros(B, bool), valid=jnp.ones(B, bool))
        saved = (jfastpath._winner, jfastpath.sweep2_nearest_edge,
                 jsweep2g.sweep2g_nearest_edge)
        jfastpath._winner = lambda *a: obj
        jfastpath.sweep2_nearest_edge = jsweep2g.sweep2g_nearest_edge = found
        try:
            h, _, alpha = jfastpath.intersect_diff(accel, scene, o, d, tr, ones * 1e30, soft)
        finally:
            (jfastpath._winner, jfastpath.sweep2_nearest_edge,
             jsweep2g.sweep2g_nearest_edge) = saved
        out = (h.t, h.normal, h.local_pos)
        return out + (alpha,) if soft > 0.0 else out

    return fn, [jnp.asarray(x[f]) for f in FIELDS]


CASES = [("spheres", 0.0), ("spheres", 0.03), ("generic", 0.0), ("generic", 0.03)]


def _cotangents(outs, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=tuple(v.shape)).astype(np.float32) for v in outs]


@pytest.mark.parametrize("mode,soft", CASES)
def test_plain_recompute_equals_jax_and_its_vjp(mode, soft):
    x = lanes(mode)
    fn, args = jax_recompute(x, mode, soft)
    want, vjp = jax.vjp(fn, *args)
    inputs = port_inputs(x)
    got = rc.winner_recompute_plain(*inputs, soft=soft, mode=mode)
    got = got if soft > 0.0 else got[:3]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.isfinite(g.numpy()).all()
        assert float(np.abs(g.numpy() - w).max()) <= 5e-4 * float(np.abs(w).max())
        if x["tie"].any():  # an exact tie: the same face, the same bits
            np.testing.assert_array_equal(g.numpy()[x["tie"]], w[x["tie"]])
    cts = _cotangents(want, 1)
    want_g = vjp(tuple(jnp.asarray(c) for c in cts))
    fn_t, xs = rc._plain_of(inputs, soft, mode == "spheres")
    _, vjp_t = torch.func.vjp(fn_t, *xs)
    got_g = list(vjp_t(tuple(torch.from_numpy(c) for c in cts)))
    safe = torch.from_numpy(np.maximum(x["obj"], 0)).long()
    for k, name in enumerate(FIELDS):
        g = got_g[k]
        if name in ROWS:  # the lanes' gradients into their rows
            g = torch.zeros_like(g).index_add_(0, safe, g)
        w = np.asarray(want_g[k])
        scale = float(np.abs(w).max())
        assert scale > 0.0, name
        assert float(np.abs(g.numpy() - w).max()) <= 5e-4 * scale, name


@pytest.mark.parametrize("mode,soft", CASES)
def test_the_function_on_the_cpu_is_the_plain_version(mode, soft):
    """``winner_recompute`` (the ``autograd.Function``) on CPU tensors: the
    plain version's outputs, its reverse-mode gradient and its tangent."""
    inputs = port_inputs(lanes(mode, seed=3))
    fn_t, xs = rc._plain_of(inputs, soft, mode == "spheres")

    def through(*xs):
        o, d, tr, pos, dpos, rot, scale = xs
        out = rc.winner_recompute(o, d, tr, inputs[3], pos, dpos, rot, scale, inputs[8],
                                  soft=soft, mode=mode)
        return out if soft > 0.0 else out[:3]

    want, vjp_w = torch.func.vjp(fn_t, *xs)
    got, vjp_g = torch.func.vjp(through, *xs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    cts = tuple(torch.from_numpy(c) for c in _cotangents(want, 2))
    for g, w in zip(vjp_g(cts), vjp_w(cts)):
        assert torch.equal(g, w)
    tans = tuple(torch.from_numpy(c) for c in _cotangents(xs, 4))
    for g, w in zip(torch.func.jvp(through, tuple(xs), tans)[1],
                    torch.func.jvp(fn_t, tuple(xs), tans)[1]):
        assert torch.equal(g, w)


def _l1(a, b):
    return float((a.double() - b).abs().sum())


@pytest.mark.skipif(shutil.which("g++") is None, reason="the host rehearsal needs g++")
@pytest.mark.parametrize("mode,soft", CASES)
def test_kernel_source_rehearsed_on_the_host(mode, soft):
    x = lanes(mode, seed=5)
    spheres = mode == "spheres"
    inputs = port_inputs(x)
    inputs64 = port_inputs(x, torch.float64)
    want = rc._recompute_plain(inputs, soft, spheres)
    want64 = rc._recompute_plain(inputs64, soft, spheres)
    with _build.host_rehearsal():
        got = rc._launch_recompute(inputs, soft, spheres)
    assert len(got) == len(want) == (4 if soft > 0.0 else 3)
    close = torch.ones(B, dtype=torch.bool)
    for g, w in zip(got, want):
        ok = (g - w).abs() <= 1e-4 * (1.0 + w.abs())
        close &= ok.reshape(B, -1).all(1)
    assert float(close.float().mean()) >= 0.99
    tie = torch.from_numpy(x["tie"])
    for g, w in zip(got, want):  # the tie lanes: exact in either order
        assert torch.equal(g[tie], w[tie])

    rng = np.random.default_rng(6)
    grads = [torch.from_numpy(rng.normal(size=tuple(w.shape)).astype(np.float32)) for w in want]
    ref = rc._recompute_grad_plain(inputs64, [g.double() for g in grads], soft, spheres)
    with _build.host_rehearsal():
        kern = rc._launch_recompute_grad(inputs, grads, soft, spheres)
    for name, k, r in zip(FIELDS, kern, ref):
        assert bool(torch.isfinite(k).all()), name
        assert _l1(k, r) <= 1e-3 * float(r.abs().sum()), name
        if tie.any():
            assert float((k[tie].double() - r[tie]).abs().max()) <= 1e-5 * float(
                r.abs().max()), name

    xs64 = [inputs64[k] for k in rc._AT]
    tans = [torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32)) for v in xs64]
    ref = rc._recompute_jvp_plain(inputs64, [t.double() for t in tans], soft, spheres)
    with _build.host_rehearsal():
        kern = rc._launch_recompute_jvp(inputs, tans, soft, spheres)
    for k, r in zip(kern, ref):
        assert bool(torch.isfinite(k).all())
        assert _l1(k, r) <= 1e-3 * float(r.abs().sum())
        if tie.any():
            assert float((k[tie].double() - r[tie]).abs().max()) <= 1e-5 * float(r.abs().max())


@pytest.mark.skipif(shutil.which("g++") is None, reason="the host rehearsal needs g++")
def test_the_rehearsed_backward_skips_what_is_not_needed():
    """A null gradient pointer writes nothing; a missing output gradient is
    zero."""
    inputs = port_inputs(lanes("generic", seed=7))
    out = rc._recompute_plain(inputs, 0.0, False)
    g_t = torch.ones_like(out[0])
    need = [True, False, False, True, False, True, False]
    with _build.host_rehearsal():
        got = rc._launch_recompute_grad(inputs, [g_t, None, None], 0.0, False, need)
        full = rc._launch_recompute_grad(inputs, [g_t, torch.zeros_like(out[1]),
                                                  torch.zeros_like(out[2])], 0.0, False)
    for g, f, n in zip(got, full, need):
        assert (g is not None) == n
        if n:
            assert torch.equal(g, f)


def _bits(a, b):
    """Equal bit for bit (a float's bits, so NaNs in the same places), or
    both None."""
    if a is None or b is None:
        return a is None and b is None
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _lanes_at(inputs, grads, at):
    """The inputs and gradients of lanes ``at``: views where ``at`` is a
    slice, copies where it is an index tensor."""
    return [x[at] for x in inputs], [None if q is None else q[at] for q in grads]


def _within_plain(kernel, ref, plain):
    """The kernel's float32 gradient against float64 autograd ``ref`` of the
    plain version: its largest error within the float32 plain version's own
    plus 1e-5 of the sum of |ref|, its summed error at most twice the plain
    version's plus 1e-6 of that sum."""
    err = (kernel.double() - ref).abs()
    perr = (plain.double() - ref).abs()
    s = float(ref.abs().sum())
    return (bool(torch.isfinite(kernel).all())
            and float(err.max()) <= float(perr.max()) + 1e-5 * s
            and float(err.sum()) <= 2.0 * float(perr.sum()) + 1e-6 * s)


BLOCK = 128  # lanes a block of the backward kernel (csrc/recompute.cu GRAD_THREADS)


def _three_times(mode, seed):
    """The port's inputs of ``lanes(mode, seed)`` three times over (3 B
    lanes, more than three blocks), in float32 and in float64."""
    x = lanes(mode, seed=seed)
    return ([torch.cat([v] * 3) for v in port_inputs(x)],
            [torch.cat([v] * 3) for v in port_inputs(x, torch.float64)])


@pytest.mark.skipif(shutil.which("g++") is None, reason="the host rehearsal needs g++")
@pytest.mark.parametrize("mode,soft", [("spheres", 0.0), ("generic", 0.03)])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [0, 1, BLOCK - 1, BLOCK + 1, 3 * BLOCK + 5])
def test_the_rehearsed_backward_in_blocks_equals_its_lanes_one_at_a_time(n, offset, mode, soft):
    """The backward over n lanes (a ragged last block; below one block;
    every field a view one lane in, so no base is 16-byte aligned) equals
    bit for bit the same lanes run one a launch, and is within the plain
    version's own float32 error of float64 autograd of it."""
    spheres = mode == "spheres"
    full, full64 = _three_times(mode, 10)
    want = rc._recompute_plain(full, soft, spheres)
    rng = np.random.default_rng(11)
    grads = [torch.from_numpy(rng.normal(size=tuple(w.shape)).astype(np.float32)) for w in want]
    at = slice(offset, offset + n)
    inputs, grads = _lanes_at(full, grads, at)
    with _build.host_rehearsal():
        got = rc._launch_recompute_grad(inputs, grads, soft, spheres)
        one = [rc._launch_recompute_grad(*_lanes_at(inputs, grads, slice(j, j + 1)), soft,
                                         spheres) for j in range(n)]
    assert len(got) == len(FIELDS)
    for k, name in enumerate(FIELDS):
        assert got[k].shape[0] == n, name
        if n:
            assert _bits(got[k], torch.cat([o[k] for o in one])), name
    if n > 1:
        ref = rc._recompute_grad_plain([v[at] for v in full64], [q.double() for q in grads],
                                       soft, spheres)
        plain = rc._recompute_grad_plain(inputs, grads, soft, spheres)
        for name, k, r, p in zip(FIELDS, got, ref, plain):
            assert _within_plain(k, r, p), name


@pytest.mark.skipif(shutil.which("g++") is None, reason="the host rehearsal needs g++")
@pytest.mark.parametrize("soft", [0.0, 0.03])
def test_a_block_of_mixed_branches_permutes_with_its_lanes(soft):
    """Lanes that take every branch of the backward (spheres, that is
    isotropic unrotated ellipsoids, rotated ellipsoids and cuboids, each hit
    and missed) over more than one block: permuting the input lanes permutes
    every input's gradient bit for bit."""
    x = lanes("generic", seed=12)
    sph = slice(0, 48)
    x["obj_type"][sph], x["rotation"][sph] = 1, np.eye(3, dtype=np.float32)
    x["scale"][sph] = x["scale"][sph][:, :1]
    # misses of every type: a missed lane keeps its own row here (the
    # renderer's read row 0, whatever its type)
    missed = slice(40, 100)
    x["hit"][missed] = False
    x["obj"][missed] = np.arange(B)[missed]
    inputs = port_inputs(x)
    kinds = {(int(t), bool(h)) for t, h in zip(inputs[8].tolist(), inputs[3].tolist())}
    assert {(1, True), (1, False), (2, True), (2, False)} <= kinds
    want = rc._recompute_plain(inputs, soft, False)
    rng = np.random.default_rng(13)
    grads = [torch.from_numpy(rng.normal(size=tuple(w.shape)).astype(np.float32)) for w in want]
    perm = torch.from_numpy(rng.permutation(B))
    with _build.host_rehearsal():
        got = rc._launch_recompute_grad(inputs, grads, soft, False)
        moved = rc._launch_recompute_grad(*_lanes_at(inputs, grads, perm), soft, False)
    for name, g, m in zip(FIELDS, got, moved):
        assert _bits(g[perm], m), name


def test_the_wrappers_check_their_arguments():
    inputs = port_inputs(lanes("spheres", seed=8))
    with pytest.raises(RuntimeError, match="take CUDA tensors"):
        rc._launch_recompute(inputs, 0.0, True)
    bad = list(inputs)
    bad[0] = bad[0].double()
    with _build.host_rehearsal(), pytest.raises(ValueError, match="o:"):
        rc._launch_recompute(bad, 0.0, True)
    bad = list(inputs)
    bad[3] = bad[3].int()
    with _build.host_rehearsal(), pytest.raises(ValueError, match="hit:"):
        rc._launch_recompute(bad, 0.0, True)
    with _build.host_rehearsal(), pytest.raises(ValueError, match="gradients for"):
        rc._launch_recompute_grad(inputs, [None] * 4, 0.0, True)
    with pytest.raises(ValueError, match="mode"):
        rc.winner_recompute(*inputs, soft=0.0, mode="spherical")


def test_winner_recompute_on_a_device_tensor_never_calls_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU goes to the kernels: with their
    launch replaced by a stub, a 'meta' tensor reaches it, and the plain
    versions are never called."""
    inputs = [x.to("meta") for x in port_inputs(lanes("spheres", seed=9))]
    called = []

    def plain(*a, **k):
        raise AssertionError("the plain version was called")

    monkeypatch.setattr(rc, "_recompute_plain", plain)
    monkeypatch.setattr(rc, "_recompute_grad_plain", plain)
    monkeypatch.setattr(rc, "_recompute_jvp_plain", plain)
    monkeypatch.setattr(rc, "_launch_recompute",
                        lambda inp, soft, sph: called.append("fwd") or rc._outputs(B, soft, "meta"))
    out = rc.winner_recompute(*inputs, soft=0.03, mode="spheres")
    assert called == ["fwd"] and len(out) == 4 and out[0].device.type == "meta"


def _nested_glass():
    """A glass sphere holding a denser one and a rotated glass cube, and an
    air sphere inside it: points inside one to three rows."""
    from raytracing_tests_tpu_torch.scene.types import SceneBuilder

    b = SceneBuilder()
    b.add_dielectric((0.0, 0.0, 0.0), 1.2, ior=1.3)
    b.add_dielectric((0.15, 0.05, 0.0), 0.6, ior=1.8)
    b.add_box((-0.1, -0.1, -0.1), (0.5, 0.5, 0.5), refractive_index=1.6, refractivity=1.0,
              rotation_deg=(20.0, 30.0, 0.0))
    b.add_sphere((-0.5, 0.4, 0.2), 0.3, refractive_index=1.0)
    return b.build(capacity=6)


def _function_cases():
    """{a ``torch.autograd.Function`` of the port: (a function of float64 CPU
    tensors through it -> a tuple of its outputs, the primals)}."""
    from raytracing_tests_tpu_torch.kernels import gather, ri_sum

    rng = np.random.default_rng(11)
    n, lanes_g = 9, 40
    table = torch.from_numpy(rng.normal(size=(n, sum(gather.WIDTHS))))
    ints = torch.from_numpy(rng.integers(0, 3, (n, 3)).astype(np.int32))
    obj = torch.from_numpy(rng.integers(-1, n, lanes_g).astype(np.int32))

    def through_gather(t):
        out = gather.winner_gather(t, obj, ints, widths=gather.WIDTHS,
                                   grad_cols=gather.GRAD_COLUMNS)
        return out[:9]  # the fields with a gradient

    scene = _nested_glass()
    scene = scene.replace(**{f: getattr(scene, f).double() for f in
                             ("position", "delta_position", "rotation", "scale")})
    point = torch.from_numpy(rng.uniform(-1.3, 1.3, (256, 3)))
    tr = torch.from_numpy(rng.uniform(0.0, 1.0, 256))

    def through_sum(ri):
        return (ri_sum.containment_ri(scene.replace(refractive_index=ri), point, tr),)

    inputs = port_inputs(lanes("generic", seed=12), torch.float64)

    def through_recompute(o, d, tr, pos, dpos, rot, scale):
        return rc.winner_recompute(o, d, tr, inputs[3], pos, dpos, rot, scale, inputs[8],
                                   soft=0.03, mode="generic")

    def through_constant(x):  # the winner search's kind: an index from the values
        return (x * 2.0, _build.constant(lambda v: (v * 2.0, torch.argmax(v)), x)[0])

    # the shading with soft edges and lights, its scatter cones shut (their
    # sunflower offset is computed in float32, as the reference's is)
    from test_torch_shade import lanes as shade_lanes

    from raytracing_tests_tpu_torch.kernels import shade

    sx, (spp, max_bounces, t_max, bg) = shade_lanes(14, True, True, dtype=torch.float64, n=64)
    sx[10], sx[11] = torch.zeros_like(sx[10]), torch.zeros_like(sx[11])

    def through_shade(*xs):
        out = shade.shade_bvh(*xs, *sx[shade.N_FLOAT:], spp=spp, max_bounces=max_bounces,
                              t_max=t_max, background=bg)
        return tuple(out[k] for k in shade._FLOAT_AT)

    # the queue's pop and push pair (``kernels.queue``), on stacks with media
    from raytracing_tests_tpu_torch.kernels import queue as rq
    from raytracing_tests_tpu_torch.ops.render import RayQueue

    qb, qcap = 24, 3
    size0 = torch.from_numpy(rng.integers(0, qcap + 1, qb))
    kids = [(torch.from_numpy(rng.uniform(size=qb) < p), torch.from_numpy(
        rng.integers(0, 5, qb).astype(np.int32))) for p in (0.7, 0.5)]
    stacks0 = [torch.from_numpy(rng.normal(size=(qcap + 1, qb) + ((3,) if w == 3 else ())))
               for w in (rq.WIDTHS[n] for n in rq.FLOATS)]

    def queue_of(stacks):
        q = RayQueue.create(qb, qcap, "cpu", media=True)
        q.stacks.update({n: s * 1.0 for n, s in zip(rq.FLOATS, stacks)})  # not leaves
        q.size = size0.clone()
        return q

    def through_pop(*stacks):
        q = queue_of(stacks)
        got = rq.queue_pop(q)
        return (*[x for x in got[1:] if x.is_floating_point()],
                *[q.stacks[n] for n in rq.FLOATS])

    def through_push2(*xs):  # the second child without media: air
        q = queue_of(xs[8:])
        (m1, b1), (m2, b2) = kids
        rq.queue_push2(q, (m1, *xs[:3], b1, xs[3], xs[4]), (m2, *xs[5:8], b2))
        return tuple(q.stacks[n] for n in rq.FLOATS)

    values = [torch.from_numpy(rng.normal(size=(qb,) + ((3,) if rq.WIDTHS[n] == 3 else ())))
              for _ in range(2) for n in rq.FLOATS]

    return {_build._Constant: (through_constant, (table[:, 0].clone(),)),
            rq._QueuePop: (through_pop, tuple(stacks0)),
            rq._QueuePush2: (through_push2, tuple(values[:8]) + tuple(stacks0)),
            gather._WinnerGather: (through_gather, (table,)),
            ri_sum._ContainmentRI: (through_sum, (scene.refractive_index.double(),)),
            rc._WinnerRecompute: (through_recompute, tuple(inputs[k] for k in rc._AT)),
            shade._ShadeBvh: (through_shade, tuple(sx[:shade.N_FLOAT]))}


def test_every_autograd_function_of_the_port_supports_torch_func():
    """Every ``torch.autograd.Function`` subclass in the port defines
    ``setup_context`` and a ``jvp``, and ``torch.func.jvp`` and
    ``torch.func.vjp`` run through it on CPU tensors and agree: <g, J t> =
    <J^T g, t> within 1e-9 of the terms' sum of magnitudes (float64); a
    constant's outputs (``_build.constant``'s: a kernel's launch inside a
    ``jvp`` or ``backward``, the winner search) carry neither.  A Function added later without a case here fails the
    test."""
    import importlib
    import pkgutil

    import raytracing_tests_tpu_torch as pkg

    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if not m.name.endswith("__main__"):
            importlib.import_module(m.name)

    def subclasses(c):
        for s in c.__subclasses__():
            yield s
            yield from subclasses(s)

    found = {c for c in subclasses(torch.autograd.Function)
             if c.__module__.startswith(pkg.__name__ + ".")}
    cases = _function_cases()
    assert found == set(cases)
    rng = np.random.default_rng(13)
    for cls, (fn, primals) in cases.items():
        assert "setup_context" in vars(cls) and "jvp" in vars(cls), cls
        tans = tuple(torch.from_numpy(rng.normal(size=tuple(p.shape))) for p in primals)
        out, jv = torch.func.jvp(fn, primals, tans)
        out2, vjp = torch.func.vjp(fn, *primals)
        for a, b in zip(out, out2):
            assert torch.equal(a, b), cls
        cts = tuple(torch.from_numpy(rng.normal(size=tuple(v.shape))) for v in out)
        back = vjp(cts)
        if cls.__name__ == "_Constant":  # x * 2 beside it moves; the constant does not
            assert torch.equal(jv[0], 2.0 * tans[0]) and not bool(jv[1].any())
            assert torch.equal(back[0], 2.0 * cts[0])
            continue
        lhs = sum(float((c * j).sum()) for c, j in zip(cts, jv))
        rhs = sum(float((b * t).sum()) for b, t in zip(back, tans))
        size = (sum(float((c * j).abs().sum()) for c, j in zip(cts, jv))
                + sum(float((b * t).abs().sum()) for b, t in zip(back, tans)))
        assert size > 0.0, cls
        assert abs(lhs - rhs) <= 1e-9 * size, (cls, lhs, rhs)


def _rehearsed(kernel):
    """A dispatcher's kernel route (a forward's ``_launch_*``, a backward's or
    a tangent's ``_*_kernel``) with its launch run by the kernel source as
    host C++."""
    def run(*args, **kw):
        with _build.host_rehearsal():
            return kernel(*args, **kw)

    return run


@pytest.mark.skipif(shutil.which("g++") is None, reason="the host rehearsal needs g++")
@pytest.mark.parametrize("soft", [0.0, 0.03])
def test_the_step_through_the_rehearsed_kernels(monkeypatch, soft):
    """A banded gradient step on the CPU with the recompute's forward and
    backward run by the kernel source as host C++ (the winner gather and the
    containment sum plain): the loss within rtol 2e-5 and every gradient
    within 1e-3 of its field's max |g| of the plain route (the kernels sum a
    vector's three components in the card's order, the plain version in the
    CPU's, and the ground sphere's quadratic, radius 1000, cancels all but a
    few bits in float32: found 3.2e-6 on the soft loss and 2.3e-4 on the
    positions; on the card the -fmad=false build sums in the plain version's
    order, ``chip_smoke.py``'s ``recompute_vs_plain``), and one ``winner_recompute`` launched for
    each call of ``intersect_diff`` and one ``winner_recompute_grad`` for each
    but a band's last where the edges are hard (that pop's hit feeds only
    children that no pop reads; with soft edges its coverage reaches the
    colour)."""
    from raytracing_tests_tpu_torch import diff
    from raytracing_tests_tpu_torch.diff import fastpath
    from raytracing_tests_tpu_torch.ops.render import RenderConfig
    from raytracing_tests_tpu_torch.scene import examples

    scene, cam = examples.iow_final_scene(side=5)
    cfg = RenderConfig(width=16, height=8, spp=2, max_bounces=3,
                       intersector="pallas").for_scene(scene)
    cfg = dataclasses.replace(cfg, soft_edges=soft)
    pert = scene.replace(color=scene.color * 0.8 + 0.1, position=scene.position + 0.01)
    target = torch.full((cfg.height, cfg.width, 3), 0.5)
    p = diff.extract_params(pert)
    calls = []
    real = fastpath.intersect_diff

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    def step():
        vg = diff.banded_value_and_grad(pert, cam, cfg, grad_bands=2, device="cpu")
        vg(p, target)  # probes the RI slots
        calls.clear()
        _build.reset_launches()
        return vg(p, target)

    monkeypatch.setattr(fastpath, "intersect_diff", counted)
    loss_plain, grads_plain = step()
    monkeypatch.setattr(rc, "_recompute", _rehearsed(rc._launch_recompute))
    monkeypatch.setattr(rc, "_recompute_grad", _rehearsed(rc._recompute_grad_kernel))
    loss, grads = step()
    launches = dict(_build.LAUNCHES)
    _build.reset_launches()
    assert launches == {"winner_recompute": len(calls),
                        "winner_recompute_grad": len(calls) - (2 if soft == 0.0 else 0)}
    np.testing.assert_allclose(float(loss), float(loss_plain), rtol=2e-5)
    for name, want in grads_plain.items():
        scale = float(want.abs().max())
        assert float((getattr(grads, name) - want).abs().max()) <= 1e-3 * max(scale, 1e-30), name


@pytest.mark.skipif(shutil.which("g++") is None, reason="the host rehearsal needs g++")
def test_forward_mode_through_the_rehearsed_kernels(monkeypatch):
    """``torch.func.jvp`` of ``render_loss`` on the fast path over a glass
    scene (``materials_scene()``, 24x16x2 at depth 3) with the kernels'
    routes of the winner gather, the recompute and the containment sum run
    by their sources as host C++: within 1e-4 of the sum |g v| of the plain
    route's tangent, and the tangents by their kernels (``winner_gather`` on
    the tangent table, ``winner_recompute_jvp``, ``ri_sum_jvp``), one a
    forward launch."""
    from raytracing_tests_tpu_torch import diff
    from raytracing_tests_tpu_torch.kernels import gather, ri_sum
    from raytracing_tests_tpu_torch.ops.render import RenderConfig
    from raytracing_tests_tpu_torch.scene import examples

    scene, cam = examples.materials_scene()
    cfg = RenderConfig(width=24, height=16, spp=2, max_bounces=3,
                       intersector="pallas").for_scene(scene)
    assert cfg.has_dielectrics
    pert = scene.replace(color=scene.color * 0.6 + 0.2)
    target = torch.full((cfg.height, cfg.width, 3), 0.5)
    p = diff.extract_params(pert)
    names = [n for n, _ in p.items() if n != "textures"]
    rng = np.random.default_rng(8)
    tan = tuple(torch.from_numpy(rng.normal(size=tuple(getattr(p, n).shape)).astype(np.float32))
                for n in names)

    def loss(*fields):
        return diff.render_loss(p.replace(**dict(zip(names, fields))), pert, cam, cfg, target,
                                device="cpu")

    primals = tuple(getattr(p, n) for n in names)
    _, want = torch.func.jvp(loss, primals, tan)
    _, grads = diff.value_and_grad_loss(p, pert, cam, cfg, target, device="cpu")
    terms = sum(float((getattr(grads, n) * t).abs().sum()) for n, t in zip(names, tan))
    for module, name, route in ((gather, "_gather", gather._gather_kernel),
                                (ri_sum, "_ri_sum", ri_sum._launch_ri_sum),
                                (ri_sum, "_ri_sum_jvp", ri_sum._ri_sum_jvp_kernel),
                                (rc, "_recompute", rc._launch_recompute),
                                (rc, "_recompute_jvp", rc._recompute_jvp_kernel)):
        monkeypatch.setattr(module, name, _rehearsed(route))
    _build.reset_launches()
    _, got = torch.func.jvp(loss, primals, tan)
    launches = dict(_build.LAUNCHES)
    _build.reset_launches()
    assert abs(float(got) - float(want)) <= 1e-4 * terms, (float(got), float(want), terms)
    n = launches["winner_recompute"]
    assert n > 0 and launches["winner_recompute_jvp"] == n and launches["winner_gather"] == 2 * n
    assert launches["ri_sum"] > 0 and launches["ri_sum_jvp"] == launches["ri_sum"]
