"""The queue renderer's ray queue as kernels (``kernels.queue``,
``csrc/queue.cu``).

- ``queue_pop`` and ``queue_push2``, the kernel source compiled as host C++
  (``_build.host_rehearsal``), against the plain versions (``RayQueue``'s
  pop and push as they were) on seeded masks and values: full queues,
  overflow into the spill slot, empty lanes, pushes of one and of two
  children, media on and off, B not a multiple of the block.  Stacks (the
  spill slot included), sizes, drop counts, popped values and active flags
  equal bit for bit (``torch.equal``: the kernels copy and select).
- The autograd functions (``_QueuePop``, ``_QueuePush2``), their routes run
  by the rehearsed kernels and by the kernels' plain versions, against
  autograd of the plain versions over a sequence of pops and pushes: the
  gradient of every pushed value and the popped values bit for bit; and
  ``torch.func.jvp`` and ``torch.func.vjp`` through them likewise.  The
  values are multiples of 1/8 and the weights small integers, so every sum
  is exact whatever order autograd adds in.
- The gradient buffer changed in place is sound where it is not the
  chain's own: a stack that also reaches the loss mid-trace, the last stack's
  gradient arriving as autograd's expanded zeros, and ``torch.func.vjp``.
- A banded gradient step (``diff.banded_value_and_grad``) and
  ``torch.func.jvp`` of ``render_loss`` with the queue run by the rehearsed
  kernels equal the plain route's loss and every gradient bit for bit (the
  plain route is held against ``jax.value_and_grad`` by
  ``test_torch_diff.py``), with the kernels' launch counts of a band.
- A tensor that is not on the CPU never reaches a plain version; the
  launches check their arguments and refuse CPU tensors outside the
  rehearsal.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from raytracing_tests_tpu_torch.kernels import _build
from raytracing_tests_tpu_torch.kernels import queue as rq
from raytracing_tests_tpu_torch.ops.render import RayQueue

torch.set_num_threads(2)

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="the host rehearsal needs g++")


def _rehearsed(kernel):
    def run(*args, **kw):
        with _build.host_rehearsal():
            return kernel(*args, **kw)

    return run


def _route(monkeypatch, how: str):
    """Send ``RayQueue``'s pops and pushes through the autograd functions,
    their launches run by the kernel source as host C++ (``"rehearsed"``)
    or by the kernels' plain versions (``"function"``); ``"plain"`` leaves
    the CPU's route."""
    if how == "plain":
        return
    monkeypatch.setattr(rq, "pop", rq.queue_pop)
    monkeypatch.setattr(rq, "push2", rq.queue_push2)
    if how == "rehearsed":
        for route, kernel in (("_pop", rq._launch_pop), ("_push2", rq._launch_push2),
                              ("_pop_tangent", rq._pop_tangent_kernel),
                              ("_push2_tangent", rq._push2_tangent_kernel),
                              ("_pop_grad", rq._pop_grad_kernel),
                              ("_push2_grad", rq._push2_grad_kernel)):
            monkeypatch.setattr(rq, route, _rehearsed(kernel))


def _script(seed: int, B: int, media: bool, steps: int = 24, dyadic: bool = False):
    """Seeded pops and pushes: ("pop",) or ("push", children), each child
    (mask, o, d, c, bounced, medium, parent_medium) as numpy.  The masks
    fill every queue early (overflow), then thin out; a few are all false
    or all true.  Four pops at the end empty every queue of capacity 3."""
    rng = np.random.default_rng(seed)

    def floats(*shape):
        if dyadic:
            return (rng.integers(-16, 17, size=shape) / 8.0).astype(np.float32)
        return rng.normal(size=shape).astype(np.float32)

    ops = []
    for step in range(steps):
        if step in (3, 4, 9) or (step > 0 and rng.uniform() < 0.4):
            ops.append(("pop",))
            continue
        kids = []
        for _ in range(1 if step == 0 or rng.uniform() < 0.25 else 2):
            p = 0.95 if step < 8 else rng.choice([0.0, 0.4, 1.0])
            mask = rng.uniform(size=B) < p
            with_media = media and rng.uniform() < 0.7
            kids.append((mask, floats(B, 3), floats(B, 3), floats(B),
                         rng.integers(0, 9, size=B).astype(np.int32),
                         floats(B) if with_media else None, floats(B) if with_media else None))
        ops.append(("push", kids))
    return ops + [("pop",)] * 4  # drain: every lane empty, then a pop of empty lanes


def _torch_child(kid):
    return tuple(None if x is None else torch.from_numpy(x) for x in kid)


@needs_gxx
@pytest.mark.parametrize("media", [False, True])
@pytest.mark.parametrize("B", [333, 256])
def test_rehearsed_kernels_equal_the_plain_versions(media, B):
    """Every step of a seeded script by ``_launch_pop`` / ``_launch_push2``
    (host C++) and by ``queue_pop_plain`` / ``queue_push2_plain`` on a copy of
    the queue: everything bit for bit, the spill slot included."""
    Q = 3
    plain = RayQueue.create(B, Q, "cpu", media=media)
    kern = RayQueue.create(B, Q, "cpu", media=media)
    dropped, full = 0, False
    for op in _script(5 + B, B, media):
        if op[0] == "pop":
            want = rq.queue_pop_plain(plain)
            with _build.host_rehearsal():
                active, got, size = rq._launch_pop(kern.stacks, kern.size)
            kern.size = size
            assert torch.equal(active, want[0])
            for name, w in zip(rq.FIELDS + rq.MEDIA, want[1:]):
                assert (w is None) == (name not in got), name
                if w is not None:
                    assert torch.equal(got[name], w), name
        else:
            kids = [_torch_child(k) for k in op[1]]
            want = rq.queue_push2_plain(plain, *kids)
            with _build.host_rehearsal():
                size, got = rq._launch_push2(kern.stacks, kern.size, [
                    (k[0], dict(zip(rq.FLOATS, (k[1], k[2], k[3], k[5], k[6])), bounced=k[4]))
                    for k in kids])
            kern.size = size
            assert got.dim() == 0 and got.dtype == torch.int64 and int(got) == int(want)
            dropped += int(got)
        for name, s in plain.stacks.items():
            assert torch.equal(kern.stacks[name], s), name
        assert torch.equal(kern.size, plain.size)
        full = full or int(plain.size.max()) == Q
    assert dropped > 0 and full and int(plain.size.max()) == 0


def _run(ops, B, media, leaves=None, probe=None):
    """Run ``ops`` on a fresh CPU queue through ``RayQueue``'s methods (as
    routed) -> (the loss, the pushed values that are leaves).  A child's
    floats are its seeded values plus the last popped values times 1/2 (so
    the gradient crosses the queue more than once); the loss weighs each
    popped float by a seeded integer.  ``probe(step, queue)`` may add a
    term of its own."""
    rng = np.random.default_rng(1)
    q = RayQueue.create(B, 3, "cpu", media=media)
    leaves = [] if leaves is None else leaves
    last, loss = None, torch.zeros(())
    k = 0
    for step, op in enumerate(ops):
        if op[0] == "pop":
            got = q.pop()
            popped = dict(zip(rq.FIELDS + rq.MEDIA, got[1:]))
            last = {n: popped[n] for n in rq.FLOATS if popped[n] is not None}
            for v in last.values():
                w = torch.from_numpy(rng.integers(-3, 4, size=tuple(v.shape)).astype(np.float32))
                loss = loss + (v * w).sum()
        else:
            kids = []
            for kid in op[1]:
                mask, o, d, c, b, m, p = _torch_child(kid)
                vals = dict(origin=o, direction=d, contribution=c, medium=m, parent_medium=p)
                for n, v in vals.items():
                    if v is None:
                        continue
                    if len(leaves) <= k:
                        leaves.append(v.clone().requires_grad_(True))
                    x = leaves[k]
                    k += 1
                    if last is not None and n in last:
                        x = x + last[n] * 0.5
                    vals[n] = x
                kids.append((mask, vals["origin"], vals["direction"], vals["contribution"], b,
                             vals["medium"], vals["parent_medium"]))
            q.push2(*kids)
        if probe is not None:
            loss = loss + probe(step, q)
    return loss, leaves


@pytest.mark.parametrize("how", ["function", pytest.param("rehearsed", marks=needs_gxx)])
@pytest.mark.parametrize("media", [False, True])
def test_the_backward_equals_autograd_of_the_plain_versions(monkeypatch, how, media):
    """The gradient of the loss with respect to every pushed value through
    the autograd functions equals autograd's through the plain versions, bit
    for bit, and the rehearsed route launches each backward kernel."""
    B = 70
    ops = _script(9, B, media, dyadic=True)
    loss_p, leaves_p = _run(ops, B, media)
    grads_p = torch.autograd.grad(loss_p, leaves_p, allow_unused=True)
    _route(monkeypatch, how)
    _build.reset_launches()
    loss_k, leaves_k = _run(ops, B, media)
    grads_k = torch.autograd.grad(loss_k, leaves_k, allow_unused=True)
    launches = dict(_build.LAUNCHES)
    _build.reset_launches()
    assert torch.equal(loss_k, loss_p)
    assert len(grads_k) == len(grads_p) > 0
    for i, (gk, gp) in enumerate(zip(grads_k, grads_p)):
        assert (gk is None) == (gp is None), i
        if gp is not None:
            assert torch.equal(gk, gp), i
    assert any(g is not None and bool(g.any()) for g in grads_p)
    if how == "rehearsed":
        pops = sum(op[0] == "pop" for op in ops)
        assert launches["queue_pop"] == pops and launches["queue_push2"] == len(ops) - pops
        assert 0 < launches["queue_pop_grad"] <= pops
        assert 0 < launches["queue_push2_grad"] <= len(ops) - pops


@pytest.mark.parametrize("how", ["function", pytest.param("rehearsed", marks=needs_gxx)])
@pytest.mark.parametrize("case", ["second_consumer", "expanded_zeros", "func_vjp", "func_jvp"])
def test_the_gradient_buffer_is_sound_where_it_is_not_the_chains_own(monkeypatch, how, case):
    """The gradient through the kernels' route equals the plain route's bit
    for bit where the buffer a step gets is not the one the chain handed
    down: ``queue.stacks`` read into the loss mid-trace (autograd sums that
    term's gradient and the chain's), the last stacks read into the loss
    times 0 (their gradient arrives as an expanded zero tensor), and under
    ``torch.func.vjp`` and ``torch.func.jvp`` (the tangent along every
    leaf)."""
    B, media = 40, True
    ops = _script(21, B, media, steps=18, dyadic=True)
    weights = np.random.default_rng(2).integers(-2, 3, size=(4, B)).astype(np.float32)

    def probe(step, q):
        st = q.stacks
        if case == "second_consumer" and step in (5, 11):
            w = torch.from_numpy(weights[step % 4])
            return ((st["origin"] * w[None, :, None]).sum() + (st["contribution"] * w).sum()
                    + st["medium"].sum())
        if case == "expanded_zeros" and step == len(ops) - 1:
            return sum(s.sum() for n, s in st.items() if n != "bounced") * 0.0
        return torch.zeros(())

    def grads():
        if case in ("second_consumer", "expanded_zeros"):
            loss, leaves = _run(ops, B, media, probe=probe)
            return (loss, *torch.autograd.grad(loss, leaves))
        _, leaves = _run(ops, B, media)
        primals = tuple(x.detach() for x in leaves)

        def fn(*xs):
            return _run(ops, B, media, leaves=list(xs), probe=probe)[0]

        if case == "func_vjp":
            loss, vjp = torch.func.vjp(fn, *primals)
            return (loss, *vjp(torch.ones(())))
        tans = tuple(torch.from_numpy(np.random.default_rng(3).integers(
            -2, 3, size=tuple(x.shape)).astype(np.float32)) for x in primals)
        return torch.func.jvp(fn, primals, tans)

    want = grads()
    _route(monkeypatch, how)
    got = grads()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert any(bool(w.any()) for w in want[1:])


def _counted(monkeypatch, fn):
    """fn() -> (its result, the pops and the traces (queues made) it ran,
    the kernel launches it made)."""
    pops, traces = [], []
    pop, create = rq.pop, RayQueue.create.__func__

    def counted_pop(q):
        pops.append(1)
        return pop(q)

    def counted_create(cls, *a, **k):
        traces.append(1)
        return create(cls, *a, **k)

    _build.reset_launches()
    with monkeypatch.context() as m:
        m.setattr(rq, "pop", counted_pop)
        m.setattr(RayQueue, "create", classmethod(counted_create))
        out = fn()
    launches = dict(_build.LAUNCHES)
    _build.reset_launches()
    return out, len(pops), len(traces), launches


def _band_case(soft):
    from raytracing_tests_tpu_torch import diff
    from raytracing_tests_tpu_torch.ops.render import RenderConfig
    from raytracing_tests_tpu_torch.scene import examples

    scene, cam = examples.materials_scene()
    cfg = RenderConfig(width=16, height=12, spp=2, max_bounces=3,
                       intersector="pallas").for_scene(scene)
    cfg = dataclasses.replace(cfg, soft_edges=soft)
    pert = scene.replace(color=scene.color * 0.6 + 0.2, position=scene.position + 0.01)
    target = torch.full((cfg.height, cfg.width, 3), 0.5)
    return diff, pert, cam, cfg, target, diff.extract_params(pert)


@needs_gxx
@pytest.mark.parametrize("soft", [0.0, 0.03])
def test_a_band_through_the_rehearsed_kernels_equals_the_plain_route(monkeypatch, soft):
    """A banded gradient step on the CPU over a glass scene with the queue
    run by its kernel source as host C++ (every other kernel plain): the
    loss and every gradient bit for bit the plain route's; each pop of a
    band launches ``queue_pop`` once and its push pair ``queue_push2`` once
    (and the primaries' push), every pop but a band's first
    ``queue_pop_grad`` and every push pair but the last
    ``queue_push2_grad``: the stacks before a band's first pop carry no
    gradient, and its last pushes reach no pop."""
    diff, pert, cam, cfg, target, p = _band_case(soft)

    def step():
        vg = diff.banded_value_and_grad(pert, cam, cfg, grad_bands=2, device="cpu")
        vg(p, target)  # probes the RI slots
        return _counted(monkeypatch, lambda: vg(p, target))

    (loss_p, grads_p), _, _, _ = step()
    _route(monkeypatch, "rehearsed")
    (loss, grads), pops, traces, launches = step()
    assert traces >= 2 and pops > traces
    assert launches["queue_pop"] == pops and launches["queue_push2"] == pops + traces
    assert launches["queue_pop_grad"] == launches["queue_push2_grad"] == pops - traces
    assert torch.equal(loss, loss_p)
    for name, want in grads_p.items():
        assert torch.equal(getattr(grads, name), want), name


@needs_gxx
def test_forward_mode_through_the_rehearsed_queue_equals_the_plain_route(monkeypatch):
    """``torch.func.jvp`` of ``render_loss`` on the fast path over a glass
    scene, the queue run by its kernel source as host C++: the loss and its
    tangent bit for bit the plain route's, the tangents by the forward
    kernels on the tangent stacks."""
    diff, pert, cam, cfg, target, p = _band_case(0.0)
    rng = np.random.default_rng(4)
    fields = tuple(getattr(p, f) for f in diff.FLOAT_FIELDS)
    tans = tuple(torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32))
                 for x in fields)

    def tloss(*xs):
        return diff.render_loss(p.replace(**dict(zip(diff.FLOAT_FIELDS, xs))), pert, cam, cfg,
                                target, device="cpu")

    want = torch.func.jvp(tloss, fields, tans)
    _route(monkeypatch, "rehearsed")
    got, pops, traces, launches = _counted(monkeypatch, lambda: torch.func.jvp(tloss, fields,
                                                                               tans))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float(want[1]) != 0.0
    # a trace's pops after its first also pop the tangent stacks, and each of
    # its push pairs pushes the children's tangents
    assert pops > traces > 0
    assert launches["queue_pop"] == 2 * pops - traces
    assert launches["queue_push2"] == 2 * pops + traces


def test_a_device_tensor_never_reaches_the_plain_versions(monkeypatch):
    """A queue that is not on the CPU goes to the kernels: with their launches
    replaced by stubs, 'meta' tensors reach them and no plain version is
    called; the sizes and drop counts come from the stubs."""
    B = 16
    q = RayQueue.create(B, 2, "meta", media=False)
    called = []

    def plain(*a, **k):
        raise AssertionError("a plain version was called")

    def pop_stub(stacks, size):
        called.append("pop")
        out = {n: torch.empty(rq._lane_shape(B, n), device="meta")
               for n in rq.FLOATS if n in stacks}
        out["bounced"] = torch.empty(B, dtype=torch.int32, device="meta")
        return (torch.empty(B, dtype=torch.bool, device="meta"), out,
                torch.empty(B, dtype=torch.int64, device="meta"))

    def push_stub(stacks, size, children):
        called.append(("push2", len(children)))
        return (torch.empty(B, dtype=torch.int64, device="meta"),
                torch.empty((), dtype=torch.int64, device="meta"))

    for name in ("queue_pop_plain", "queue_push_plain", "queue_push2_plain", "pop_rows_plain",
                 "push2_rows_plain", "queue_pop_grad_plain", "queue_push2_grad_plain"):
        monkeypatch.setattr(rq, name, plain)
    monkeypatch.setattr(rq, "_launch_pop", pop_stub)
    monkeypatch.setattr(rq, "_launch_push2", push_stub)
    z = lambda *s: torch.zeros(s, device="meta")  # noqa: E731
    kid = (torch.ones(B, dtype=torch.bool, device="meta"), z(B, 3), z(B, 3), z(B),
           torch.zeros(B, dtype=torch.int32, device="meta"))
    dropped = q.push2(kid)
    out = q.pop()
    q.push2(kid, kid)
    assert called == [("push2", 1), "pop", ("push2", 2)]
    assert dropped.device.type == "meta" and out[5] is None and out[6] is None
    assert all(o.device.type == "meta" for o in out[:5])


def test_the_launches_check_their_arguments():
    B = 8
    q = RayQueue.create(B, 2, "cpu", media=False)
    with pytest.raises(RuntimeError, match="take CUDA tensors"):
        rq._launch_pop(q.stacks, q.size)
    kid = (torch.ones(B, dtype=torch.bool),
           dict(origin=torch.zeros(B, 3), direction=torch.zeros(B, 3),
                contribution=torch.zeros(B), bounced=torch.zeros(B, dtype=torch.int32)))
    with pytest.raises(RuntimeError, match="take CUDA tensors"):
        rq._launch_push2(q.stacks, q.size, [kid])
    with pytest.raises(ValueError, match="size"):
        rq._launch_pop(q.stacks, q.size.int())
    bad = dict(q.stacks, origin=q.stacks["origin"].double())
    with pytest.raises(ValueError, match="origin stack"):
        rq._launch_pop(bad, q.size)
    with pytest.raises(ValueError, match="bounced 0"):
        rq._launch_push2(q.stacks, q.size, [(kid[0], dict(kid[1], bounced=torch.zeros(B)))])
    with pytest.raises(ValueError, match="one or two"):
        rq._launch_push2(q.stacks, q.size, [kid] * 3)
    with pytest.raises(ValueError, match="medium"):
        rq._launch_push2(q.stacks, q.size, [(kid[0], dict(kid[1], medium=torch.ones(B)))])
    with pytest.raises(ValueError, match="without media"):
        rq.queue_push2(q, (kid[0], torch.zeros(B, 3), torch.zeros(B, 3), torch.zeros(B),
                           torch.zeros(B, dtype=torch.int32), torch.ones(B)))
    G = {n: torch.zeros_like(s) for n, s in q.stacks.items() if n != "bounced"}
    with pytest.raises(ValueError, match="gradient of origin"):
        rq._launch_pop_grad(G, q.size, {"origin": torch.zeros(B, 2)})
    with pytest.raises(ValueError, match="one or two"):
        rq._launch_push2_grad(G, q.size, [kid[0]] * 3, [set()] * 3)


def test_the_plain_route_on_the_cpu_is_unchanged():
    """``RayQueue`` on the CPU runs the plain versions: no launch, and the
    pair of pushes equals two single pushes bit for bit."""
    B = 50
    ops = _script(31, B, True)
    a, b = RayQueue.create(B, 3, "cpu"), RayQueue.create(B, 3, "cpu")
    _build.reset_launches()
    for op in ops:
        if op[0] == "pop":
            for x, y in zip(a.pop(), b.pop()):
                assert (x is None and y is None) or torch.equal(x, y)
        else:
            kids = [_torch_child(k) for k in op[1]]
            da = a.push2(*kids)
            db = sum(b.push(*k) for k in kids)
            assert int(da) == int(db)
        for n in a.stacks:
            assert torch.equal(a.stacks[n], b.stacks[n])
    assert not _build.LAUNCHES
