"""Gradient-based scene optimisation (inverse rendering).

Render -> L2 loss against a target image -> gradients with respect to
``SceneParams`` -> an Adam update.  The sweeps run as kernels on detached
inputs (``diff/fastpath.py``); autograd differentiates the closed-form
recompute and the shading in plain PyTorch.  On a mesh
(``parallel.make_mesh``) the forward is row-sharded
(``parallel.render_sharded``): with every shard in this process one autograd
graph spans the shards, and under a process group each rank differentiates
its own rows and the gradients are summed over the ranks (``all_reduce``),
the psum the JAX package's ``shard_map`` transpose gives.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from raytracing_tests_tpu_torch.diff.params import SceneParams, apply_params, extract_params
from raytracing_tests_tpu_torch.ops.camera_rays import primary_rays
from raytracing_tests_tpu_torch.ops.render import (
    RenderConfig, _build_accel, finalize, render, trace_lanes,
)
from raytracing_tests_tpu_torch.scene.types import Camera, Scene
from raytracing_tests_tpu_torch.utils.device import resolve_device

REPROBE_EVERY = 25  # auto_pops: steps between re-probes of the band depths
POPS_MARGIN = 2  # auto_pops: pops added to each probed band depth


def _diff_cfg(cfg: RenderConfig) -> RenderConfig:
    """Gradient-rendering config: validate, and route the ``pallas``
    intersector to the fast gradient path (``diff_mode``).  The ``brute``
    intersector differentiates as it is; PyTorch's tape takes the early exit,
    so the config keeps it.  The ``bvh`` intersector is routed to ``brute``,
    as the JAX package routes it: the lockstep LBVH walk would put its
    thousands of steps on the autograd tape, and the dense sweep gives the
    same outputs."""
    from raytracing_tests_tpu_torch.diff.fastpath import fastpath_eligible

    if cfg.soft_edges > 0.0 and cfg.intersector != "pallas":
        # No other path implements the estimator: ignoring the flag would hand
        # back the biased silhouette gradients it exists to fix.
        raise ValueError(
            "soft_edges requires the fast gradient path (intersector='pallas'); "
            "both scene modes are supported")
    if fastpath_eligible(cfg):
        return dataclasses.replace(cfg, diff_mode=True)
    if cfg.intersector == "bvh":
        return dataclasses.replace(cfg, intersector="brute")
    return cfg


def _home(mesh, device) -> torch.device:
    """Where the loss and the parameters live: ``device``, or with a mesh and
    no device, the mesh's first device of this process; ``None`` without a
    mesh means the GPU."""
    if device is None and mesh is not None:
        return mesh.home
    return resolve_device(device)


def render_loss(params: SceneParams, template: Scene, camera: Camera, cfg: RenderConfig,
                target, mesh=None, lights=None, device=None):
    """Mean squared pixel error of the render against ``target`` (H, W, 3).
    ``device=None`` means the GPU (with a mesh: the mesh's first device).

    ``mesh``: the forward is ``parallel.render_sharded``.  With every shard in
    this process the loss's graph spans them all.  Under a process group the
    value is the global loss on every rank (the ranks' squared-error sums,
    all-reduced), but its graph holds this rank's rows only: its gradient is
    this rank's share, which ``value_and_grad_loss`` sums over the ranks.
    (A differentiable gather of the image would count every pixel world-size
    times, each rank holding the same loss.)"""
    cfg = _diff_cfg(cfg)
    dev = _home(mesh, device)
    scene = apply_params(template, params)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    if mesh is None:
        out = render(scene, camera, cfg, lights, device=dev)
        return torch.mean((out["image"] - target) ** 2)
    from raytracing_tests_tpu_torch.parallel.render_sharded import (
        render_sharded, trace_shards)

    if not mesh.distributed:
        out = render_sharded(scene, camera, cfg, mesh, lights)
        return torch.mean((out["image"].to(dev) - target) ** 2)
    from raytracing_tests_tpu_torch.parallel.mesh import ROWS_AXIS, shard_rows

    (shard, colors, primary_t, _, _), = trace_shards(scene, camera, cfg, mesh, lights)
    rows = torch.from_numpy(shard_rows(cfg.height, mesh.shape[ROWS_AXIS], shard)).to(dev)
    img = finalize(colors, primary_t, cfg)["image"].to(dev)
    mine = torch.sum((img - target[rows]) ** 2) / target.numel()
    total = mine.detach().clone()
    torch.distributed.all_reduce(total, group=mesh.group)
    return total + (mine - mine.detach())  # the value is total's, bit for bit


def _leaves(params: SceneParams, device):
    """Fresh autograd leaves of ``params`` on ``device``."""
    return params.map(lambda v: v.detach().to(device).requires_grad_(True))


def _grads_of(value, leaves: SceneParams, accumulate: Optional[SceneParams] = None):
    """d value / d leaves as a ``SceneParams`` (zeros where unused), added to
    ``accumulate`` when given."""
    names = [n for n, _ in leaves.items()]
    tensors = [v for _, v in leaves.items()]
    got = torch.autograd.grad(value, tensors, allow_unused=True)
    got = {n: torch.zeros_like(t) if g is None else g for n, t, g in zip(names, tensors, got)}
    if accumulate is not None:
        got = {n: getattr(accumulate, n) + g for n, g in got.items()}
    return leaves.replace(**got)


def value_and_grad_loss(params: SceneParams, template: Scene, camera: Camera,
                        cfg: RenderConfig, target, mesh=None, lights=None, device=None):
    """(loss, grads) of ``render_loss`` by autograd over the whole frame.

    Under a process group (``mesh.distributed``) each rank's gradient is its
    own rows' share; they are summed over the ranks (``all_reduce``), so every
    rank returns the global loss and gradient."""
    dev = _home(mesh, device)
    leaves = _leaves(params, dev)
    loss = render_loss(leaves, template, camera, cfg, target, mesh, lights, dev)
    grads = _grads_of(loss, leaves)
    if mesh is not None and mesh.distributed:
        for _, g in grads.items():
            torch.distributed.all_reduce(g, group=mesh.group)
    return loss.detach(), grads


def _probe_lanes(camera, cfg, dev):
    H, W, S = cfg.height, cfg.width, cfg.spp
    o, d, tr = primary_rays(camera.to(dev), W, H, S)
    sidx = torch.arange(S, dtype=torch.float32, device=dev).expand(H, W, S)
    return o, d, tr, sidx


def _probe_cfg(cfg):
    """The gradient path's own forward, with the early exit: the probe counts
    the pops of exactly the trees the gradient traces.  (The JAX package
    probes with its forward renderer, whose trees can be shallower: on a
    1000-radius ground sphere the closed-form recompute and the sweep's
    refine round apart, and a band's recomputed trees can run deeper than
    the forward's.)"""
    return dataclasses.replace(_diff_cfg(cfg), early_exit=True)


@torch.no_grad()
def probe_max_pops(scene: Scene, camera: Camera, cfg: RenderConfig, lights=None,
                   device=None) -> int:
    """Pop steps the deepest ray tree of this (scene, camera, cfg) needs: the
    early-exit step count of the gradient path's forward over the full frame
    (detached).

    A gradient step over ``min(probed, cfg.pops)`` pops is EXACT for this
    scene: the steps cut would pop empty queues.  Training moves the scene, so
    ``make_train_step(auto_pops=True)`` adds a margin and re-probes."""
    cfg = _probe_cfg(cfg)
    dev = resolve_device(device)
    scene, lights = scene.to(dev), None if lights is None else lights.to(dev)
    o, d, tr, sidx = _probe_lanes(camera, cfg, dev)
    flat = lambda x: x.reshape((-1,) + x.shape[3:])
    accel = _build_accel(scene, cfg)
    return int(trace_lanes(scene, lights, cfg, flat(o), flat(d), flat(tr), flat(sidx),
                           accel, return_pops=True)[4])


@torch.no_grad()
def probe_band_pops(scene: Scene, camera: Camera, cfg: RenderConfig, grad_bands: int,
                    lights=None, device=None) -> list:
    """``probe_max_pops`` per row band: the true max ray-tree depth of each of
    ``grad_bands`` bands.  Sky-only bands measure 1; glass-heavy bands run to
    the budget — ``banded_value_and_grad(band_pops=...)`` buckets the bands by
    these depths so shallow bands stop paying the deepest band's length."""
    cfg = _probe_cfg(cfg)
    H, W, S = cfg.height, cfg.width, cfg.spp
    assert H % grad_bands == 0, (H, grad_bands)
    h = H // grad_bands
    dev = resolve_device(device)
    scene, lights = scene.to(dev), None if lights is None else lights.to(dev)
    o, d, tr, sidx = _probe_lanes(camera, cfg, dev)
    flat = lambda x: x.reshape((h * W * S,) + x.shape[3:])
    accel = _build_accel(scene, cfg)
    out = []
    for b in range(grad_bands):
        sl = slice(b * h, (b + 1) * h)
        out.append(int(trace_lanes(scene, lights, cfg, flat(o[sl]), flat(d[sl]),
                                   flat(tr[sl]), flat(sidx[sl]), accel,
                                   return_pops=True)[4]))
    return out


def _buckets(band_pops, grad_bands: int, pops: int):
    """Group bands into at most 3 buckets by probed depth: [(ceiling, bands)]."""
    assert len(band_pops) == grad_bands, (len(band_pops), grad_bands)
    caps = np.minimum(np.asarray(band_pops, np.int64), pops)
    ceilings = sorted(set(int(c) for c in caps))
    while len(ceilings) > 3:  # merge the two closest ceilings
        i = int(np.argmin(np.diff(ceilings)))
        ceilings.pop(i)  # the bands under the removed ceiling run deeper
    buckets, prev = [], 0
    for ceil in ceilings:
        idxs = tuple(b for b in range(grad_bands) if prev < caps[b] <= ceil)
        if idxs:
            buckets.append((ceil, idxs))
        prev = ceil
    return buckets


def banded_value_and_grad(template: Scene, camera: Camera, cfg: RenderConfig,
                          lights=None, grad_bands: int = 8, grad_pops: Optional[int] = None,
                          band_pops=None, device=None):
    """Gradient ACCUMULATION over image row bands: ``f(params, target) ->
    (loss, grads)``, equal to ``value_and_grad_loss`` (the MSE is a pixel
    mean, so the bands' squared-error sums add up to it) at 1/``grad_bands``
    of the backward's peak memory: each band's graph is freed before the next
    band is traced.

    ``grad_pops``: a probed scan length (``probe_max_pops``), exact when at
    least the scene's true depth; ``cfg.pops`` clamps it.  ``band_pops``: each
    band's probed depth (``probe_band_pops``): the bands are grouped into at
    most 3 buckets, each traced at its own ceiling.  The accel depends only on
    the detached scene, so one is built per call and shared by the bands."""
    cfg = _diff_cfg(cfg)
    if grad_pops is not None:
        cfg = dataclasses.replace(cfg, max_pops=min(int(grad_pops), cfg.pops))
    H, W, S = cfg.height, cfg.width, cfg.spp
    assert H % grad_bands == 0, (H, grad_bands)
    h = H // grad_bands
    if band_pops is None:
        buckets = [(None, tuple(range(grad_bands)))]
    else:
        buckets = _buckets(band_pops, grad_bands, cfg.pops)

    def f(params: SceneParams, target):
        dev = resolve_device(device)
        leaves = _leaves(params, dev)
        scene = apply_params(template.to(dev), leaves)
        lt = None if lights is None else lights.to(dev)
        o, d, tr, sidx = _probe_lanes(camera, cfg, dev)
        tgt = torch.as_tensor(target, dtype=torch.float32, device=dev)
        accel = _build_accel(scene, cfg)
        flat = lambda x: x.reshape((h * W * S,) + x.shape[3:])
        sse = torch.zeros((), dtype=torch.float32, device=dev)
        grads = None
        for ceil, idxs in buckets:
            cfg_c = cfg if ceil is None else dataclasses.replace(cfg, max_pops=ceil)
            for b in idxs:
                sl = slice(b * h, (b + 1) * h)
                color, primary_t, _, _ = trace_lanes(
                    scene, lt, cfg_c, flat(o[sl]), flat(d[sl]), flat(tr[sl]),
                    flat(sidx[sl]), accel)
                img = finalize(color.reshape(h, W, S, 3), primary_t.reshape(h, W, S),
                               cfg_c)["image"]
                s_b = torch.sum((img - tgt[sl]) ** 2)
                grads = _grads_of(s_b, leaves, grads)
                sse = sse + s_b.detach()
        n = H * W * 3
        return sse / n, grads.map(lambda g: g / n)

    return f


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """The optimiser of ``TrainState`` / ``make_train_step``:
    ``torch.optim.Adam`` with ``optax.adam``'s parameters (its ``eps`` is
    added to the bias-corrected root, as optax's is)."""
    return functools.partial(torch.optim.Adam, lr=learning_rate, betas=(b1, b2), eps=eps)


_ADAM_KEYS = ("step", "exp_avg", "exp_avg_sq")


@dataclasses.dataclass
class TrainState:
    """Scene parameters, the optimiser over them, and the step count.

    ``params`` holds plain tensors (the optimiser's leaves); the optimiser's
    state is made at creation (Adam's step and both moments per field), so a
    fresh state and one after any number of steps have the same leaves —
    ``app.checkpoint`` saves and restores them."""

    params: SceneParams
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, scene: Scene, optimizer, device=None) -> "TrainState":
        dev = resolve_device(device)
        params = extract_params(scene).map(lambda v: v.detach().to(dev).clone())
        return cls(params=params, optimizer=_make_optimizer(optimizer, params), step=0)

    @property
    def opt_state(self) -> dict:
        """Field name -> {'step', 'exp_avg', 'exp_avg_sq'} of the optimiser."""
        return {n: self.optimizer.state[v] for n, v in self.params.items()}

    def tree_flatten(self):
        return [self.params, [{k: s[k] for k in _ADAM_KEYS} for s in self.opt_state.values()],
                self.step]

    def tree_unflatten(self, children):
        params, opt_state, step = children
        optimizer = _make_optimizer(self.optimizer.defaults, params)
        for (_, v), s in zip(params.items(), opt_state):
            for k in _ADAM_KEYS:
                optimizer.state[v][k].copy_(s[k])
        return TrainState(params=params, optimizer=optimizer, step=int(step))


def _make_optimizer(spec, params: SceneParams) -> torch.optim.Optimizer:
    """An Adam over ``params`` with its state made now.  ``spec``: what
    ``adam`` returns, or an optimiser's ``defaults``."""
    tensors = [v for _, v in params.items()]
    if isinstance(spec, dict):
        spec = functools.partial(torch.optim.Adam, **{
            k: spec[k] for k in ("lr", "betas", "eps")})
    opt = spec(tensors)
    if not isinstance(opt, torch.optim.Adam):
        raise TypeError(f"TrainState takes an Adam (see diff.train.adam), got {type(opt)}")
    for v in tensors:
        # Adam's own lazy initialisation, done now: a CPU float step and
        # zero moments.
        opt.state[v] = {"step": torch.zeros((), dtype=torch.float32),
                        "exp_avg": torch.zeros_like(v, memory_format=torch.preserve_format),
                        "exp_avg_sq": torch.zeros_like(v, memory_format=torch.preserve_format)}
    return opt


def make_train_step(template: Scene, camera: Camera, cfg: RenderConfig, optimizer=None,
                    mesh=None, lights=None, trainable: Optional[SceneParams] = None,
                    grad_bands: int = 1, auto_pops: bool = False, device=None):
    """The training step: value and gradient -> masked gradient -> Adam.

    Returns ``step(state, target) -> (state, loss)``; the state's tensors are
    updated in place and returned in a new ``TrainState``.  ``optimizer`` is
    what ``adam`` returns and must be the one the state was created with.

    ``trainable`` optionally masks which fields update (a ``SceneParams`` of
    0/1 tensors, multiplied into the gradients before the update).  Autograd
    through the renderer differentiates the smooth shading only; silhouette
    jumps are invisible to it unless ``cfg.soft_edges > 0``, so geometry sees
    biased gradients near edges.

    ``grad_bands > 1`` accumulates the gradient over image row bands
    (``banded_value_and_grad``): the same loss and gradients at 1/bands of the
    backward's peak memory — what a full-resolution frame needs.  Single
    device only, as in the JAX package: with a ``mesh`` (the sharded step,
    ``value_and_grad_loss(mesh=)``) it is refused, and so is ``auto_pops``,
    which needs bands.

    ``auto_pops`` (banded only): probe each band's depth with the early-exit
    forward and trace the bands at those depths + 2.  Training can DEEPEN ray
    trees (an object turning reflective opens spawn gates the probe saw
    closed), which would truncate the cut traces, so the step re-probes the
    current params every ``REPROBE_EVERY`` (25) steps and rebuilds the buckets
    when a band outgrew its margin (``step.pops_state``)."""
    if mesh is not None and grad_bands > 1:
        raise ValueError("grad_bands composes with single-device only (mesh=None)")
    if auto_pops and grad_bands <= 1:
        raise ValueError(
            "auto_pops requires grad_bands > 1 (the probed depths are per row "
            "band; pass e.g. grad_bands=8)")
    pops_state = {"band_pops": None, "since": 0}
    vg = None
    if grad_bands > 1:
        if auto_pops:
            pops_state["band_pops"] = [p + POPS_MARGIN for p in probe_band_pops(
                template, camera, cfg, grad_bands, lights, device)]
        vg = banded_value_and_grad(template, camera, cfg, lights, grad_bands=grad_bands,
                                   band_pops=pops_state["band_pops"], device=device)
    vg_box = [vg]  # the re-probe swaps the closure in place

    def step(state: TrainState, target):
        if auto_pops:
            pops_state["since"] += 1
            if pops_state["since"] >= REPROBE_EVERY:
                pops_state["since"] = 0
                fresh = probe_band_pops(apply_params(template, state.params), camera, cfg,
                                        grad_bands, lights, device)
                if any(f > b for f, b in zip(fresh, pops_state["band_pops"])):
                    pops_state["band_pops"] = [p + POPS_MARGIN for p in fresh]
                    vg_box[0] = banded_value_and_grad(
                        template, camera, cfg, lights, grad_bands=grad_bands,
                        band_pops=pops_state["band_pops"], device=device)
        if vg_box[0] is not None:
            loss, grads = vg_box[0](state.params, target)
        else:
            loss, grads = value_and_grad_loss(state.params, template, camera, cfg, target,
                                              mesh, lights, device)
        if trainable is not None:
            grads = grads.replace(**{
                n: g * torch.as_tensor(getattr(trainable, n), dtype=g.dtype, device=g.device)
                for n, g in grads.items()})
        for (_, v), (_, g) in zip(state.params.items(), grads.items()):
            v.grad = g.to(v.device)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        return (TrainState(params=state.params, optimizer=state.optimizer,
                           step=state.step + 1), loss)

    step.pops_state = pops_state  # test / introspection hook
    return step
