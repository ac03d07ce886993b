"""CPU oracle renderer: a direct, scalar, per-sample transcription of the
path tracer's semantics (bvh and materials shading, textures, lights, motion
blur), written in plain float64 numpy with an explicit Python ray stack.

Deliberately shares NO renderer code with ``ops/``, ``kernels/`` or ``bvh/``:
this is the independent spec the vectorized renderer and the kernels behind
it are tested against.  Only the ``Scene`` / ``Camera`` containers and the
render config are shared; their tensors are read once as numpy.  On equal
float32 inputs it gives the JAX package's oracle's output bit for bit.

Keep this slow and obvious. Use tiny resolutions in tests.
"""

from __future__ import annotations

import numpy as np

from raytracing_tests_tpu_torch.ops.render import RenderConfig
from raytracing_tests_tpu_torch.scene.types import Camera, Scene

ELLIPSOID, CUBOID = 1, 2
GOLDEN_ANGLE = np.pi * (3.0 - np.sqrt(5.0))


def _np(x):
    """A tensor's values as a numpy array."""
    return x.detach().cpu().numpy()


def _normalize(v):
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def _sunflower(i, n, aperture):
    if i == 0:
        return np.zeros(2)
    b = np.round(2 * np.sqrt(n))
    half = aperture * 0.5
    r = half if i > n - b else half * np.sqrt((i - 0.5) / (n - (b + 1) / 2.0))
    th = GOLDEN_ANGLE * i
    return np.array([r * np.cos(th), r * np.sin(th)])


def _deviate(direction, i, n, tan_theta):
    off = _sunflower(i, n, 2.0 * tan_theta)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(direction, up)
    up2 = np.cross(right, direction)
    return _normalize(direction + 0.1 * (off[0] * right + off[1] * up2))


def _reflect(d, n):
    return d - 2.0 * np.dot(d, n) * n


def _refract(d, n, eta):
    cos_i = -np.dot(d, n)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    if k < 0:
        return np.zeros(3)
    return eta * d + (eta * cos_i - np.sqrt(k)) * n


def _primitive_t(o, d, scale, typ):
    if typ == ELLIPSOID:
        oo, dd = o / scale, d / scale
        half_b = np.dot(oo, dd)
        a = np.dot(dd, dd)
        c = np.dot(oo, oo) - 1.0
        disc = half_b * half_b - a * c
        if disc <= 0:
            return -1.0
        t0 = (-half_b - np.sqrt(disc)) / a
        t1 = (-half_b + np.sqrt(disc)) / a
        t = t1 if (t0 > t1 or t0 < 0) else t0
        return t if t > 0 else -1.0
    if typ == CUBOID:
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (-scale * 0.5 - o) / d
            t2 = (scale * 0.5 - o) / d
        tmin = np.max(np.minimum(t1, t2))
        tmax = np.min(np.maximum(t1, t2))
        if tmax <= tmin:
            return -1.0
        t = tmin if tmin > 0 else tmax
        return t if t > 0 else -1.0
    return -1.0


def _primitive_normal(p, scale, typ):
    if typ == ELLIPSOID:
        return _normalize(p / (scale * scale))
    dists = [
        abs(p[0] - scale[0] * 0.5),
        abs(p[0] + scale[0] * 0.5),
        abs(p[1] - scale[1] * 0.5),
        abs(p[1] + scale[1] * 0.5),
        abs(p[2] - scale[2] * 0.5),
        abs(p[2] + scale[2] * 0.5),
    ]
    f = int(np.argmin(dists))
    n = np.zeros(3)
    n[f // 2] = 1.0 if f % 2 == 0 else -1.0
    return n


class _SceneView:
    """Numpy view of the Scene SoA restricted to valid objects."""

    def __init__(self, scene: Scene):
        valid = _np(scene.valid)
        idx = np.nonzero(valid)[0]
        for name in (
            "position rotation scale delta_position obj_type color refractive_index "
            "refractivity reflectivity scatter_refract scatter_reflect texture_index "
            "emissive"
        ).split():
            setattr(self, name, _np(getattr(scene, name))[idx])
        self.n = len(idx)
        self.textures = None if scene.textures is None else _np(scene.textures)
        rs = self.rotation * self.scale[:, None, :]
        half = np.sqrt(np.sum(rs * rs, axis=-1))
        last = self.position - self.delta_position
        self.bb_min = np.minimum(self.position, last) - half
        self.bb_max = np.maximum(self.position, last) + half
        self.light_idx = np.nonzero(self.emissive)[0]


def _intersect(view: _SceneView, o, d, ratio, t_limit):
    """Nearest object hit: returns (t, obj, world_normal, local_pos/scale)."""
    best = (t_limit, -1, None, None)
    for j in range(view.n):
        R = view.rotation[j]
        shift = (1.0 - ratio) * view.delta_position[j]
        lo = R.T @ (o - view.position[j] + shift)
        ld = R.T @ d
        t = _primitive_t(lo, ld, view.scale[j], int(view.obj_type[j]))
        if 0 < t < best[0]:
            p_local = lo + t * ld
            n = R @ _primitive_normal(p_local, view.scale[j], int(view.obj_type[j]))
            best = (t, j, n, p_local / view.scale[j])
    return best


def _surrounding_ri(view: _SceneView, point, ratio):
    """Mean RI over containing objects with RI != 1 (optically dense
    containers; an RI-1 container is air and cannot move the result —
    skipping it keeps the estimate undiluted when geometry overlaps, and
    lets the device kernels probe a dielectric-only sub-table)."""
    acc, cnt = 0.0, 0
    for j in range(view.n):
        if view.refractive_index[j] == 1.0:
            continue
        R = view.rotation[j]
        shift = (1.0 - ratio) * view.delta_position[j]
        p = (R.T @ (point - view.position[j] + shift)) / view.scale[j]
        if int(view.obj_type[j]) == ELLIPSOID:
            inside = np.dot(p, p) <= 1.0
        else:
            inside = bool(np.all(np.abs(p) <= 0.5))
        if inside:
            acc += view.refractive_index[j]
            cnt += 1
    return acc / cnt if acc > 1.0 else 1.0


def _texture_color(view: _SceneView, j, local_unit):
    ti = int(view.texture_index[j])
    if view.textures is None or ti <= 0:
        return np.ones(3)
    p = local_unit
    ax = np.abs(p)
    face, dom = (1 if p[0] > 0 else 3), ax[0]
    if ax[1] > dom:
        face, dom = (0 if p[1] > 0 else 5), ax[1]
    if ax[2] > dom:
        face, dom = (2 if p[2] > 0 else 4), ax[2]
    face_dirn = {
        0: [0, 1, 0],
        1: [1, 0, 0],
        2: [0, 0, 1],
        3: [-1, 0, 0],
        4: [0, 0, -1],
        5: [0, -1, 0],
    }[face]
    q = p / np.dot(p, face_dirn) * 0.5 + 0.5
    uv = {
        0: (q[0], 1 - q[2]),
        1: (1 - q[1], 1 - q[2]),
        2: (q[0], q[1]),
        3: (q[2], q[1]),
        4: (1 - q[1], 1 - q[0]),
        5: (q[2], 1 - q[0]),
    }[face]
    atlas = view.textures[ti]
    H, W6, _ = atlas.shape
    fx = (face + np.clip(uv[0], 0, 1)) / 6.0 * W6 - 0.5
    fy = np.clip(uv[1], 0, 1) * H - 0.5
    x0, y0 = int(np.clip(np.floor(fx), 0, W6 - 1)), int(np.clip(np.floor(fy), 0, H - 1))
    x1, y1 = min(x0 + 1, W6 - 1), min(y0 + 1, H - 1)
    wx, wy = np.clip(fx - x0, 0, 1), np.clip(fy - y0, 0, 1)
    return (atlas[y0, x0] * (1 - wx) + atlas[y0, x1] * wx) * (1 - wy) + (
        atlas[y1, x0] * (1 - wx) + atlas[y1, x1] * wx
    ) * wy


def _shadow_factor(view: _SceneView, hit_point, normal, sample_ratio, ratio, cfg):
    L = len(view.light_idx)
    lit = 0
    origin = hit_point + 1e-4 * normal
    for li in view.light_idx:
        bb_min, bb_max = view.bb_min[li], view.bb_max[li]
        center = (bb_min + bb_max) * 0.5
        target = bb_min + (bb_max - bb_min) * sample_ratio
        t_lim = np.linalg.norm(center - origin) + np.linalg.norm(bb_max - bb_min)
        d = _normalize(target - origin)
        t, j, _, _ = _intersect(view, origin, d, ratio, t_lim)
        if j >= 0 and view.emissive[j]:
            lit += 1
    return lit / max(L, 1)


def _trace_sample(view, cfg, o, d, sample_idx, spp, has_lights):
    """One sample: the explicit LIFO ray stack of the GLSL kernel."""
    ratio = sample_idx / spp
    stack = [(o, d, 1.0, 0)]
    color = np.zeros(3)
    primary_t = cfg.t_max
    pops = 0
    while stack and pops < cfg.pops:
        pops += 1
        o, d, contrib, bounced = stack.pop()
        t, j, normal, local_unit = _intersect(view, o, d, ratio, cfg.t_max)
        if bounced == 0:
            primary_t = t if j >= 0 else cfg.t_max
        if j < 0:  # miss -> background
            if has_lights:
                bg = np.zeros(3)
            else:
                tt = (d[1] + 1.0) * 0.5
                bg = (1 - tt) * np.array(cfg.background[0]) + tt * np.array(cfg.background[1])
            color += contrib * bg
            continue

        hit_point = o + t * d
        sur_ri = _surrounding_ri(view, hit_point + 1e-3 * normal, ratio)
        mat_color = view.color[j] * _texture_color(view, j, local_unit)

        if has_lights:
            if view.emissive[j]:
                return np.ones(3), primary_t
            contrib *= _shadow_factor(view, hit_point, normal, sample_idx / spp, ratio, cfg)

        bounced += 1
        refl, refr = view.reflectivity[j], view.refractivity[j]
        can_spawn = (refl > 0.002 or refr > 0.002) and contrib > 0.01 and bounced < cfg.max_bounces
        refl_dir = np.zeros(3)
        refr_dir = np.zeros(3)
        inner = np.dot(normal, d) > 0
        n = normal.copy()
        if not inner:
            if refl > 0.002:
                refl_dir = _normalize(_reflect(d, n))
                if view.scatter_reflect[j] > 0.001:
                    refl_dir = _deviate(refl_dir, sample_idx, spp, view.scatter_reflect[j])
            if refr > 0.002:
                refr_dir = _refract(d, n, sur_ri / view.refractive_index[j])
                if np.dot(refr_dir, refr_dir) > 0:
                    refr_dir = _normalize(refr_dir)
                    if view.scatter_refract[j] > 0.001:
                        refr_dir = _deviate(refr_dir, sample_idx, spp, view.scatter_refract[j])
        else:
            n = -n
            refr_dir = _refract(d, n, view.refractive_index[j] / sur_ri)
            if np.dot(refr_dir, refr_dir) < 0.1:
                refl_dir = _reflect(d, n)

        forward = 0.0
        if can_spawn and np.dot(refr_dir, refr_dir) > 0.1:
            stack.append((hit_point - 1e-4 * n, refr_dir, contrib * refr, bounced))
            forward += refr
        if can_spawn and np.dot(refl_dir, refl_dir) > 0.1:
            stack.append((hit_point + 1e-4 * n, refl_dir, contrib * refl, bounced))
            forward += refl
        contrib *= 1.0 - 0.5 * forward
        color += contrib * mat_color
    return color, primary_t


def _fibonacci_hemisphere(i, n, scatteritivity, focus_dirn):
    """``fibonacciHemiSpherePtDirn`` (03_Shadows glsl:164-184)."""
    y = 1.0 - i / float(max(n - 1, 1))
    radius = np.sqrt(max(1.0 - y * y, 0.0))
    theta = GOLDEN_ANGLE * i
    x = np.cos(theta) * radius
    z = np.sin(theta) * radius
    s = scatteritivity
    x, y, z = x * s, y * s, z * s
    y_cap = focus_dirn
    z_cap = _normalize(np.cross(np.array([0.0, 1.0, 0.0]), y_cap))
    x_cap = _normalize(np.cross(y_cap, z_cap))
    return _normalize(focus_dirn + x * x_cap + y * y_cap + z * z_cap)


def _schlick(cosine, ratio):
    r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def _trace_sample_materials(view, cfg, o, d, sample_idx, spp):
    """IOW-03 materials model (03_Shadows_and_Materials glsl:285-357):
    per-ray medium RI (depth-2 medium stack), Schlick contribution shift,
    always-spawned scattered reflection on outer hits, fibonacci-hemisphere
    scatter, TIR -> contribution-1.0 reflection, contribution^2 local term."""
    ratio_t = sample_idx / spp
    stack = [(o, d, 1.0, 1.0, 1.0, 0)]  # o, d, contrib, medium, parent, bounced
    color = np.zeros(3)
    primary_t = cfg.t_max
    pops = 0
    while stack and pops < cfg.pops:
        pops += 1
        o, d, contrib, medium, parent, bounced = stack.pop()
        t, j, normal, local_unit = _intersect(view, o, d, ratio_t, cfg.t_max)
        if bounced == 0:
            primary_t = t if j >= 0 else cfg.t_max
        if j < 0:
            tt = (d[1] + 1.0) * 0.5
            bg = (1 - tt) * np.array(cfg.background[0]) + tt * np.array(cfg.background[1])
            color += contrib * bg
            continue

        hit_point = o + t * d
        mat_color = view.color[j] * _texture_color(view, j, local_unit)
        color += contrib * contrib * mat_color  # glsl:250 + :304

        bounced += 1
        if bounced >= cfg.max_bounces:
            continue

        cos_theta = np.dot(normal, d)  # > 0: inner hit
        inner = cos_theta > 0
        sin_theta = np.sqrt(max(1.0 - cos_theta * cos_theta, 0.0))
        target = parent if inner else view.refractive_index[j]
        ratio = medium / max(target, 1e-6)
        ratio_sin = ratio * sin_theta
        refr_c = view.refractivity[j]
        refl_c = view.reflectivity[j]

        # LaunchRay's grazing-reflection lift (glsl:230-247).
        _n_inc = -normal if inner else normal  # toward incident side
        refl_mirror = _reflect(d, normal)
        if not inner:
            n2ir = _normalize(np.cross(_n_inc, d))
            n2n = _normalize(np.cross(n2ir, _n_inc))
            s = view.scatter_reflect[j]
            inv = 1.0 / np.sqrt(1.0 + s * s)
            max_reflect = s * inv * _n_inc + inv * n2n
            if np.dot(refl_mirror, _n_inc) <= np.dot(max_reflect, _n_inc):
                refl_mirror = max_reflect

        spawn_refl = False
        refl_dir = refl_mirror
        if not inner:
            shift = refr_c * _schlick(max(-cos_theta, 0.0), ratio)
            refr_c -= shift
            refl_c += shift
            refl_dir = _fibonacci_hemisphere(
                sample_idx, spp, view.scatter_reflect[j], refl_mirror
            )
            spawn_refl = True
        elif ratio_sin > 1.0:  # inner TIR
            refl_c = 1.0
            spawn_refl = True
        else:
            refl_c = 0.0

        _n2 = normal if inner else -normal  # glsl's _normal (transmission side)
        spawn_refr = ratio_sin <= 1.0
        refr_dir = np.zeros(3)
        if spawn_refr:
            y_cap = _n2 * cos_theta
            x_cap = d - y_cap
            raw = ratio_sin * _n2 + np.sqrt(max(1.0 - ratio_sin**2, 0.0)) * x_cap
            refr_dir = _fibonacci_hemisphere(
                sample_idx, spp, view.scatter_refract[j], _normalize(raw)
            )

        # Reference push order: reflected then refracted (glsl:347-352).
        if spawn_refl and contrib * refl_c > 0.0:
            stack.append((hit_point - 1e-4 * _n2, refl_dir, contrib * refl_c,
                          medium, parent, bounced))
        if spawn_refr and contrib * refr_c > 0.0:
            new_parent = 1.0 if inner else medium
            stack.append((hit_point + 1e-4 * _n2, refr_dir, contrib * refr_c,
                          target, new_parent, bounced))
        if len(stack) > cfg.queue_capacity:
            stack = stack[: cfg.queue_capacity]  # stack_push drop (glsl:267)
    return color, primary_t


def render_cpu(scene: Scene, camera: Camera, cfg: RenderConfig):
    """Oracle render. Returns dict(image=(H, W, 3), depth=(H, W)) numpy."""
    view = _SceneView(scene)
    has_lights = cfg.enable_lights and len(view.light_idx) > 0
    H, W, S = cfg.height, cfg.width, cfg.spp

    cam_pos = _np(camera.position)
    cam_dir = _np(camera.direction)
    fov = float(camera.fov_y)
    aperture = float(camera.aperture)
    focus = float(_np(camera.focus_dist)[0])
    aspect = W / H
    screen_dist = 1.0 / (2.0 * np.tan(fov * 0.5))
    world_up = np.array([0.0, 1.0, 0.0])
    cam_right = np.cross(cam_dir, world_up)
    cam_up = np.cross(cam_right, cam_dir)

    image = np.zeros((H, W, 3))
    depth = np.zeros((H, W))
    for py in range(H):
        for px in range(W):
            srx = (px / W - 0.5) * aspect
            sry = py / H - 0.5
            base = _normalize(cam_dir * screen_dist + cam_right * srx + cam_up * sry)
            acc = np.zeros(3)
            for s in range(S):
                off = _sunflower(s, S, aperture)
                rr = np.cross(base, world_up)
                ru = np.cross(rr, base)
                tip = cam_pos + base + rr * off[0] + ru * off[1]
                look = cam_pos + base * focus
                d = _normalize(look - tip)
                o = tip - d
                if cfg.show_normals:
                    t, j, n, _ = _intersect(view, o, d, s / S, cfg.t_max)
                    col = n if j >= 0 else np.zeros(3)
                    acc += col
                    if s == S // 2:
                        depth[py, px] = t if j >= 0 else cfg.t_max
                else:
                    if cfg.shading == "materials":
                        col, pt = _trace_sample_materials(view, cfg, o, d, s, S)
                    else:
                        col, pt = _trace_sample(view, cfg, o, d, s, S, has_lights)
                    acc += np.sqrt(np.maximum(col, 0.0))
                    if s == S // 2:
                        depth[py, px] = pt
            image[py, px] = acc / S
    return {"image": image, "depth": depth}
