"""numpy <-> ``Scene`` / ``Camera`` / ``Lights`` / ``LBVH`` / ``Accel2`` /
``Accel2G`` / ``PallasAccel``.

State crosses between this package and any other array library as
dictionaries of numpy arrays keyed by field name:
``{f: np.asarray(getattr(scene, f)) for f in SCENE_FIELDS}``, plus a textured
scene's atlas stack under ``"textures"``.

``scene_params_from_numpy`` / ``scene_params_to_numpy`` do the same for the
gradient path's ``diff.SceneParams`` (a ``TrainState``'s parameters, or a
gradient), so both packages can be fed the same leaves.

``accel2_from_numpy`` takes the sphere accel in the JAX package's table
layout (``otab`` (Np + Pp, 128), the float32 ``ftab`` (24, Np) with its bf16
splits summed, ``gaabb`` (G + PG, 128), ``perm``) and re-lays it into this
package's row-major tables, so the sweep can be held against the same accel.
``accel2g_from_numpy`` and ``pallas_accel_from_numpy`` do the same for the
generic grouped accel and the first-generation sweep's accel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracing_tests_tpu_torch.bvh.build import LBVH
from raytracing_tests_tpu_torch.kernels import sweep, sweep2, sweep2g
from raytracing_tests_tpu_torch.ops.render import Lights
from raytracing_tests_tpu_torch.scene.types import Camera, Scene

SCENE_FIELDS = tuple(f.name for f in dataclasses.fields(Scene) if f.name != "textures")
CAMERA_FIELDS = tuple(f.name for f in dataclasses.fields(Camera))
LIGHTS_FIELDS = tuple(f.name for f in dataclasses.fields(Lights))
LBVH_FIELDS = tuple(f.name for f in dataclasses.fields(LBVH))

# Column indices of the JAX package's (Np, 128) object table.
_SRC_OT = {"c": slice(0, 3), "k1": 16, "ri": 19, "rinv2": 20}
_SRC_OT_MOTION = (slice(8, 11), 17, 18)  # dp, k2, k3


def _from_numpy(cls, names, leaves, device):
    missing = [n for n in names if n not in leaves]
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {missing}")
    return cls(**{
        n: torch.from_numpy(np.array(leaves[n])).to(device) for n in names})


def _to_numpy(obj, names):
    return {n: getattr(obj, n).detach().cpu().numpy() for n in names}


def scene_from_numpy(leaves: dict, device="cpu") -> Scene:
    """Every field of ``SCENE_FIELDS`` (a missing one raises ``KeyError``),
    and the atlas stack ``"textures"`` if the leaves carry one."""
    scene = _from_numpy(Scene, SCENE_FIELDS, leaves, device)
    textures = leaves.get("textures")
    if textures is not None:
        scene = scene.replace(
            textures=torch.from_numpy(np.array(textures, np.float32)).to(device))
    return scene


def scene_to_numpy(scene: Scene) -> dict:
    """``SCENE_FIELDS``, and ``"textures"`` where the scene has an atlas."""
    out = _to_numpy(scene, SCENE_FIELDS)
    if scene.textures is not None:
        out["textures"] = scene.textures.detach().cpu().numpy()
    return out


def camera_from_numpy(leaves: dict, device="cpu") -> Camera:
    return _from_numpy(Camera, CAMERA_FIELDS, leaves, device)


def camera_to_numpy(camera: Camera) -> dict:
    return _to_numpy(camera, CAMERA_FIELDS)


def lights_from_numpy(leaves: dict, device="cpu") -> Lights:
    """The emissive-object list (``bb_min``, ``bb_max``, ``geom_idx``,
    ``mask``), bit for bit."""
    return _from_numpy(Lights, LIGHTS_FIELDS, leaves, device)


def lights_to_numpy(lights: Lights) -> dict:
    return _to_numpy(lights, LIGHTS_FIELDS)


def lbvh_from_numpy(leaves: dict, device="cpu") -> LBVH:
    """An LBVH from its node arrays (``bb_min``, ``bb_max``, ``left``,
    ``right``, ``parent``, ``obj_id``), bit for bit."""
    return _from_numpy(LBVH, LBVH_FIELDS, leaves, device)


def lbvh_to_numpy(bvh: LBVH) -> dict:
    return _to_numpy(bvh, LBVH_FIELDS)


def scene_params_from_numpy(leaves: dict, device="cpu"):
    """``diff.SceneParams`` from ``{field: array}`` (every name of
    ``diff.FLOAT_FIELDS``; ``"textures"`` where the scene has an atlas)."""
    from raytracing_tests_tpu_torch.diff.params import FLOAT_FIELDS, SceneParams

    params = _from_numpy(SceneParams, FLOAT_FIELDS, leaves, device)
    textures = leaves.get("textures")
    if textures is not None:
        params = params.replace(
            textures=torch.from_numpy(np.array(textures, np.float32)).to(device))
    return params


def scene_params_to_numpy(params) -> dict:
    """``{field: array}`` of a ``SceneParams`` (a gradient too): its tensor
    fields, ``"textures"`` only where it holds one."""
    return {name: v.detach().cpu().numpy() for name, v in params.items()}


def accel2_from_numpy(otab, ftab, gaabb, perm, gr: int, device="cpu",
                      has_motion: bool = False) -> sweep2.Accel2:
    """Re-lay a sphere accel given in the JAX package's layout (see module
    docstring) into an ``Accel2``.  Without ``has_motion`` the motion delta
    must be zero; with it the accel carries the motion columns."""
    otab = np.asarray(otab, np.float32)
    ftab = np.asarray(ftab, np.float32)
    gaabb = np.asarray(gaabb, np.float32)
    n_pad = ftab.shape[1]
    if n_pad % gr:
        raise ValueError(f"ftab width {n_pad} is no multiple of gr={gr}")
    G = n_pad // gr
    n_probe = otab.shape[0] - n_pad
    if n_probe % sweep2.PROBE_GR or gaabb.shape[0] != G + n_probe // sweep2.PROBE_GR:
        raise ValueError("otab / gaabb row counts do not match the probe grouping")
    dp, k2, k3 = _SRC_OT_MOTION
    if not has_motion and otab[:, dp].any():
        raise ValueError("the tables carry motion: pass has_motion=True")
    o = np.zeros((otab.shape[0], sweep2.OT_COLS_MOTION if has_motion else sweep2.OT_COLS),
                 np.float32)
    o[:, sweep2.OT_K2] = otab[:, k2]
    o[:, sweep2.OT_K3] = otab[:, k3]
    if has_motion:
        o[:, sweep2.OT_DPX:sweep2.OT_DPZ + 1] = otab[:, dp]
    o[:, sweep2.OT_CX:sweep2.OT_CZ + 1] = otab[:, _SRC_OT["c"]]
    o[:, sweep2.OT_K1] = otab[:, _SRC_OT["k1"]]
    o[:, sweep2.OT_RI] = otab[:, _SRC_OT["ri"]]
    o[:, sweep2.OT_RINV2] = otab[:, _SRC_OT["rinv2"]]
    f = np.zeros((n_pad, sweep2.FT_COLS), np.float32)
    f[:, :sweep2.FT_R2 + 1] = ftab[:sweep2.FT_R2 + 1].T
    g = np.zeros((gaabb.shape[0], sweep2.GA_COLS), np.float32)
    g[:, 0:9] = gaabb[:, 0:9]
    t = lambda a: torch.from_numpy(np.array(a)).to(device)  # own, writable copy
    return sweep2.Accel2(
        otab=t(o), ftab=t(f), gaabb=t(g),
        perm=t(np.asarray(perm, np.int32)), gr=gr,
        n_pgroups=n_probe // sweep2.PROBE_GR, has_motion=bool(has_motion))


# Column indices of the JAX package's generic (Np, 128) object table.
_SRC_GO = {"p": slice(0, 3), "dp": slice(3, 6), "M": slice(6, 15), "type": 15,
           "valid": 16, "ri": 17, "R": slice(18, 27), "s": slice(27, 30)}


def accel2g_from_numpy(otab, ftab, gaabb, perm, gr: int, has_motion: bool,
                       n_pgroups: int, n_sgroups: int, gkinds,
                       device="cpu") -> sweep2g.Accel2G:
    """Re-lay a generic accel given in the JAX package's layout (``otab``
    (Np + Pp, 128), the float32 ``ftab`` (32, Np) with its bf16 splits summed,
    ``gaabb`` (G + PG + SGn, 128), ``perm``, and the static numbers) into an
    ``Accel2G``."""
    otab = np.asarray(otab, np.float32)
    ftab = np.asarray(ftab, np.float32)
    gaabb = np.asarray(gaabb, np.float32)
    n_pad = ftab.shape[1]
    if n_pad % gr or ftab.shape[0] != sweep2g.GFT_COLS:
        raise ValueError(f"ftab {ftab.shape}: expected ({sweep2g.GFT_COLS}, k * {gr})")
    G = n_pad // gr
    if (otab.shape[0] != n_pad + n_pgroups * sweep2.PROBE_GR
            or gaabb.shape[0] != G + n_pgroups + n_sgroups or len(gkinds) != G):
        raise ValueError("otab / gaabb / gkinds do not match the group counts")
    g = sweep2g
    o = np.zeros((otab.shape[0], g.GO_COLS), np.float32)
    o[:, g.GO_PX:g.GO_PZ + 1] = otab[:, _SRC_GO["p"]]
    o[:, g.GO_TYPE] = otab[:, _SRC_GO["type"]]
    o[:, g.GO_DPX:g.GO_DPZ + 1] = otab[:, _SRC_GO["dp"]]
    o[:, g.GO_VALID] = otab[:, _SRC_GO["valid"]]
    o[:, g.GO_SX:g.GO_SZ + 1] = otab[:, _SRC_GO["s"]]
    o[:, g.GO_RI] = otab[:, _SRC_GO["ri"]]
    o[:, g.GO_R00:g.GO_R00 + 9] = otab[:, _SRC_GO["R"]]
    o[:, g.GO_M00:g.GO_M00 + 9] = otab[:, _SRC_GO["M"]]
    ga = np.zeros((gaabb.shape[0], sweep2.GA_COLS), np.float32)
    ga[:, 0:9] = gaabb[:, 0:9]  # boxes; the probe rows also carry their anchors
    ga[:G, g.GA_KIND] = [g.KIND_CODES[k] for k in gkinds]
    t = lambda a: torch.from_numpy(np.array(a)).to(device)  # own, writable copy
    return g.Accel2G(
        otab=t(o), ftab=t(np.ascontiguousarray(ftab.T)), gaabb=t(ga),
        perm=t(np.asarray(perm, np.int32)), gr=gr, has_motion=bool(has_motion),
        n_pgroups=n_pgroups, n_sgroups=n_sgroups, gkinds=tuple(gkinds))


def pallas_accel_from_numpy(table, mode: str, hit_matrix, gaabb=None, perm=None,
                            group: int = 0, has_motion: bool = True,
                            device="cpu") -> sweep.PallasAccel:
    """Re-lay the first-generation sweep's accel given in the JAX package's
    layout (``table`` (F, N), ``hit_matrix`` (N, F), ``gaabb`` (6, G) or None,
    ``perm`` or None) into a ``PallasAccel``."""
    table = np.asarray(table, np.float32)
    rows = sweep.SPHERE_ROWS if mode == "spheres" else sweep.GENERIC_ROWS
    if table.shape[0] != rows:
        raise ValueError(f"table {table.shape}: expected {rows} rows in mode {mode!r}")
    tb = np.zeros((table.shape[1], sweep._mode_cols(mode)), np.float32)
    tb[:, :rows] = table.T
    t = lambda a: torch.from_numpy(np.array(a)).to(device)
    ga = None
    if gaabb is not None:
        gaabb = np.asarray(gaabb, np.float32)
        ga = np.zeros((gaabb.shape[1], sweep.GB_COLS), np.float32)
        ga[:, 0:6] = gaabb.T
        ga = t(ga)
    return sweep.PallasAccel(
        table=t(tb), mode=mode, hit_matrix=t(np.asarray(hit_matrix, np.float32)),
        gaabb=ga, perm=None if perm is None else t(np.asarray(perm, np.int32)),
        group=group, has_motion=bool(has_motion))
