"""The gradient path's winner gather (``kernels.gather``).

Inputs come from a numpy seed: N = 37, 488 and 1 032 rows, B = 4096 lanes,
half of them on row 0 (the ground sphere's share on the gradient path), some
on -1 (no winner: row 0 is read and takes the gradient) and the rest
uniform.

``winner_gather_plain`` is held against the JAX package's
``table[jnp.maximum(obj, 0)]`` and its ``jax.vjp``; ``winner_gather`` (the
``torch.autograd.Function``) against ``torch.autograd.gradcheck`` in
float64.  Where there is a g++, the kernel source ``csrc/gather.cu``
compiled as host C++ (``_build.host_rehearsal``) is held against the plain
versions in both modes of the backward, the shared tile and the global
mode (forced by a small shared-memory budget): the forward bit for bit (a
copy), from shared memory and through ``__ldg``; the backward bit for bit
``winner_scatter_ordered`` at the rehearsal's geometry (warps of one lane,
one block or three) and within 1e-6 of each (row, column)'s sum of |g| of a
float64 sum.  ``winner_scatter_ordered`` itself is held against a float64
``index_add_`` and, at the card's warp of 32 lanes, against a model of the
kernel's warp (its ``__match_any_sync`` groups and shuffle tree in numpy),
which the host rehearsal cannot run.  The whole gradient step through the
rehearsed kernels equals the plain route and launches one gather and one
scatter for each call of ``intersect_diff``.  ``test_torch_diff.py`` and
``test_torch_diff_train.py`` hold ``intersect_diff`` and the step, which
gather through ``winner_gather``, against the JAX package.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tests_tpu_torch import diff
from raytracing_tests_tpu_torch.diff import fastpath
from raytracing_tests_tpu_torch.kernels import _build, gather
from raytracing_tests_tpu_torch.ops.render import RenderConfig
from raytracing_tests_tpu_torch.scene import examples

torch.set_num_threads(2)

B = 4096
F = 26  # the packed table's columns: the nine trainable fields and the rotation


def _inputs(n_rows, seed=0, cols=F):
    """(table (N, cols) float32, ints (N, 3) int32, obj (B,) int32, g (B, cols))."""
    rng = np.random.default_rng(seed)
    obj = rng.integers(0, n_rows, B).astype(np.int32)
    obj[: B // 2] = 0
    obj[rng.random(B) < 0.05] = -1
    rng.shuffle(obj)
    table = rng.normal(size=(n_rows, cols)).astype(np.float32)
    ints = rng.integers(-1, 6, (n_rows, 3)).astype(np.int32)
    g = rng.normal(size=(B, cols)).astype(np.float32)
    return table, ints, obj, g


def _within_sum_abs(got, g, obj, n_rows, cols, rtol=1e-6):
    """|got - exact| against rtol times each (row, column)'s sum of |g|, the
    exact sum in float64 -> the largest ratio."""
    safe = np.maximum(obj, 0)
    exact = np.zeros((n_rows, g.shape[1]))
    scale = np.zeros_like(exact)
    np.add.at(exact, safe, g.astype(np.float64))
    np.add.at(scale, safe, np.abs(g.astype(np.float64)))
    exact[:, cols:] = 0.0
    scale[:, cols:] = 0.0
    err = np.abs(got.numpy().astype(np.float64) - exact)
    return float(np.max(err / np.maximum(rtol * scale, 1e-30)))


@pytest.mark.parametrize("n_rows", [37, 488])
def test_plain_gather_equals_jax_and_its_vjp(n_rows):
    table, ints, obj, g = _inputs(n_rows)
    safe = jnp.maximum(jnp.asarray(obj), 0)
    want, vjp = jax.vjp(lambda t: t[safe], jnp.asarray(table))
    (want_grad,) = vjp(jnp.asarray(g))
    want_ints = np.asarray(jnp.asarray(ints)[safe])

    t = torch.from_numpy(table).requires_grad_(True)
    out, iout = gather.winner_gather_plain(t, torch.from_numpy(obj), torch.from_numpy(ints))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(iout.numpy(), want_ints)
    (got_grad,) = torch.autograd.grad(out, t, torch.from_numpy(g))
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-7)
    scattered = gather.winner_scatter_plain(torch.from_numpy(g), torch.from_numpy(obj), n_rows)
    np.testing.assert_allclose(scattered.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-7)

    # the Function on the CPU: the plain versions, each field its own
    # contiguous tensor, the int columns without gradient
    t2 = torch.from_numpy(table).requires_grad_(True)
    got = gather.winner_gather(t2, torch.from_numpy(obj), torch.from_numpy(ints),
                               widths=gather.WIDTHS)
    fields, icols = got[:len(gather.WIDTHS)], got[len(gather.WIDTHS):]
    assert all(v.is_contiguous() for v in got)
    assert torch.equal(torch.cat([v.detach().reshape(B, -1) for v in fields], 1), out.detach())
    assert torch.equal(torch.stack(icols, 1), iout) and not any(c.requires_grad for c in icols)
    pieces = torch.split(torch.from_numpy(g), list(gather.WIDTHS), dim=1)
    (got2,) = torch.autograd.grad(fields, t2, [q.reshape(v.shape) for q, v in zip(pieces, fields)])
    np.testing.assert_allclose(got2.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-7)


def test_gradcheck_of_winner_gather_in_float64():
    rng = np.random.default_rng(1)
    n_rows, lanes = 7, 40
    obj = torch.from_numpy(rng.integers(-1, n_rows, lanes).astype(np.int32))
    obj[:10] = 0
    table = torch.from_numpy(rng.normal(size=(n_rows, 5))).requires_grad_(True)
    ints = torch.from_numpy(rng.integers(0, 4, (n_rows, 2)).astype(np.int32))
    assert torch.autograd.gradcheck(
        lambda t: gather.winner_gather(t, obj, ints, widths=(5,))[0], (table,))
    assert torch.autograd.gradcheck(
        lambda t: gather.winner_gather(t, obj, ints, widths=(3, 1, 1))[:3], (table,))
    # grad_cols: the fields from it on come out without gradient
    first, second, *_ = gather.winner_gather(table, obj, ints, widths=(3, 2), grad_cols=3)
    assert first.requires_grad and not second.requires_grad
    (grad,) = torch.autograd.grad(first.sum(), table)
    full = gather.winner_scatter_plain(torch.ones((lanes, 5), dtype=table.dtype), obj, n_rows)
    assert torch.equal(grad[:, :3], full[:, :3]) and not grad[:, 3:].any()


@pytest.mark.parametrize("n_rows", [37, 488])
@pytest.mark.parametrize("mode", ["tile", "global"])
def test_kernel_source_rehearsed_on_the_host(n_rows, mode):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")
    table, ints, obj, g = _inputs(n_rows, seed=n_rows)
    t, i, o, gg = map(torch.from_numpy, (table, ints, obj, g))
    want, want_i = gather.winner_gather_plain(t, o, i)
    budget = gather.SMEM_BUDGET if mode == "tile" else 1024
    widths = gather.WIDTHS
    pieces = [q.reshape(sh).contiguous() for q, sh in zip(
        torch.split(gg, list(widths), dim=1), gather._field_shapes(B, widths))]
    with _build.host_rehearsal():
        outs, iouts = gather._launch_gather(t, o, i, widths)
        got = {}
        for cols in (gather.GRAD_COLUMNS, F):  # without and with the rotation's gradient
            grads = [q if sum(widths[:k]) < cols else None for k, q in enumerate(pieces)]
            got[cols] = gather._launch_scatter(grads, o, n_rows, widths, budget)
    assert all(v.is_contiguous() for v in outs + iouts)
    assert torch.equal(torch.cat([v.reshape(B, -1) for v in outs], 1), want)
    assert torch.equal(torch.stack(iouts, 1), want_i)
    for cols, (grad, ran) in got.items():
        assert ran == mode
        assert _within_sum_abs(grad, g, obj, n_rows, cols) <= 1.0
        assert not grad[:, cols:].any()


def _pieces(g, widths, cols):
    """``g`` (B, F) cut into the fields' gradients, None from column ``cols``
    on (the fields without a gradient)."""
    pieces = [q.reshape(sh).contiguous() for q, sh in zip(
        torch.split(g, list(widths), dim=1), gather._field_shapes(g.shape[0], widths))]
    return [q if sum(widths[:k]) < cols else None for k, q in enumerate(pieces)]


@pytest.mark.parametrize("n_rows", [37, 488, 1032])
@pytest.mark.parametrize("cols", [gather.GRAD_COLUMNS, F])
@pytest.mark.parametrize("mode", ["tile", "global"])
def test_rehearsed_kernels_bit_for_bit(n_rows, cols, mode):
    """The sources rehearsed on the host: the gather from its tables staged
    in shared memory equals ``index_select`` bit for bit; the backward, in
    one block and in three, equals ``winner_scatter_ordered`` at the
    rehearsal's geometry bit for bit, and a float64 sum within 1e-6 of each
    (row, column)'s sum of |g|."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")
    table, ints, obj, g = _inputs(n_rows, seed=n_rows + cols)
    t, i, o, gg = map(torch.from_numpy, (table, ints, obj, g))
    widths = gather.WIDTHS
    grads = _pieces(gg, widths, cols)
    budget = gather.SMEM_BUDGET if mode == "tile" else 1024
    with _build.host_rehearsal():
        outs, iouts, route = gather._launch_gather_routed(t, o, i, widths)
        got = {n: gather._launch_scatter(grads, o, n_rows, widths, budget, blocks=n)
               for n in (0, 3)}
    want, want_i = gather.winner_gather_plain(t, o, i)
    assert route == "shared"
    assert torch.equal(torch.cat([v.reshape(B, -1) for v in outs], 1), want)
    assert torch.equal(torch.stack(iouts, 1), want_i)
    for blocks, (grad, ran) in got.items():
        plan = gather.scatter_plan(B, n_rows, cols, "cpu", blocks)
        assert ran == mode and plan["blocks"] == (blocks or 1) and plan["warp"] == 1
        ordered = gather.winner_scatter_ordered(grads, o, n_rows, widths, plan["warp"],
                                                plan["block_lanes"], plan["segments"])
        assert torch.equal(grad, ordered)
        assert _within_sum_abs(grad, g, obj, n_rows, cols) <= 1.0
        assert not grad[:, cols:].any()


@pytest.mark.parametrize("n_rows, budget", [(37, 0), (2100, gather.GATHER_SMEM_BUDGET)])
def test_a_table_over_the_budget_is_read_through_ldg(n_rows, budget):
    """A table whose staging would take more than the budget (2 100 rows of
    26 float and 3 int columns: 244 KB against 192 KB; or any table against
    a budget of 0) is read through ``__ldg`` by the same kernel, bit for bit
    ``index_select``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")
    t, i, o, _ = map(torch.from_numpy, _inputs(n_rows, seed=7))
    with _build.host_rehearsal():
        outs, iouts, route = gather._launch_gather_routed(t, o, i, gather.WIDTHS, budget)
    want, want_i = gather.winner_gather_plain(t, o, i)
    assert route == "ldg"
    assert torch.equal(torch.cat([v.reshape(B, -1) for v in outs], 1), want)
    assert torch.equal(torch.stack(iouts, 1), want_i)


@pytest.mark.parametrize("warp, block_lanes, segments", [(1, B, 1), (32, 32 * 9, 17),
                                                         (32, 32 * 128, 26)])
def test_the_ordered_sum_against_a_float64_index_add(warp, block_lanes, segments):
    """``winner_scatter_ordered`` on random rows with half the lanes on row 0
    against a float64 ``index_add_``: every (row, column) within 1e-6 of its
    sum of |g|, the columns without a gradient 0; with one block and warps
    of one lane it is a sum in lane order."""
    table, ints, obj, g = _inputs(488, seed=11)
    gg, o = torch.from_numpy(g), torch.from_numpy(obj)
    grads = _pieces(gg, gather.WIDTHS, gather.GRAD_COLUMNS)
    got = gather.winner_scatter_ordered(grads, o, 488, gather.WIDTHS, warp, block_lanes, segments)
    assert got.dtype == torch.float32 and got.shape == (488, F)
    assert _within_sum_abs(got, g, obj, 488, gather.GRAD_COLUMNS) <= 1.0
    assert not got[:, gather.GRAD_COLUMNS:].any()
    if warp == 1 and block_lanes == B:
        want = torch.zeros((488, F))
        for b in range(B):  # one lane after another
            want[max(int(obj[b]), 0)] += torch.cat([gg[b, :gather.GRAD_COLUMNS],
                                                     torch.zeros(F - gather.GRAD_COLUMNS)])
        assert torch.equal(got, want)


def _warp_model(g, obj, rows, block_lanes, segments):
    """``csrc/gather.cu``'s backward at warps of 32 lanes, lane by lane in
    numpy: each chunk's ``__match_any_sync`` groups, each lane's shuffle
    sources as ``tree_word`` works them out, the five shuffle steps, the
    group leaders' adds into the block's tile in chunk order, and the tiles
    summed in runs of blocks."""
    B = obj.shape[0]
    cols = g.shape[1]
    blocks = -(-B // block_lanes)
    tiles = np.zeros((blocks, rows, cols), np.float32)
    for j in range(blocks):
        end = min((j + 1) * block_lanes, B)
        for base in range(j * block_lanes, end, 32):
            idx = np.arange(base, base + 32)
            valid = idx < end
            row = np.where(valid, np.maximum(obj[np.minimum(idx, B - 1)], 0), -1)
            words = []
            for lane in range(32):
                peers = sum(1 << m for m in range(32) if row[m] == row[lane])
                rank = bin(peers & ((1 << lane) - 1)).count("1")
                above = peers & ~((2 << lane) - 1) & 0xFFFFFFFF
                skipped, steps = 0, []
                for k in range(5):
                    while above and skipped < (1 << k) - 1:
                        above &= above - 1
                        skipped += 1
                    adds = above != 0 and (rank & ((2 << k) - 1)) == 0
                    steps.append(((above & -above).bit_length() - 1 if adds else lane, adds))
                words.append((rank == 0 and row[lane] >= 0, steps))
            for c in range(cols):
                x = np.where(valid, g[np.minimum(idx, B - 1), c], 0).astype(np.float32)
                for k in range(5):
                    y = x[[words[m][1][k][0] for m in range(32)]]
                    x = np.where([words[m][1][k][1] for m in range(32)], x + y, x)
                for m in range(32):
                    if words[m][0]:
                        tiles[j, row[m], c] += x[m]
    per = -(-blocks // segments)
    out = np.zeros((rows, cols), np.float32)
    for s in range(segments):
        run = np.zeros((rows, cols), np.float32)
        for q in range(s * per, min((s + 1) * per, blocks)):
            run += tiles[q]
        out += run
    return out


def test_the_ordered_sum_is_the_kernels_order_at_a_warp_of_32():
    """At the card's warps of 32 lanes (which the host rehearsal, one lane a
    warp, cannot run), ``winner_scatter_ordered`` equals the model of the
    kernel's warp bit for bit: a ragged last chunk and block, values of
    mixed magnitudes, so that another order of adds would round apart."""
    rng = np.random.default_rng(5)
    lanes, rows = 32 * 40 + 7, 23
    obj = rng.integers(-1, rows, lanes).astype(np.int32)
    obj[rng.random(lanes) < 0.5] = 0
    g = (rng.normal(size=(lanes, 3)) * 10.0 ** rng.integers(-3, 3, (lanes, 1))).astype(np.float32)
    want = _warp_model(g, obj, rows, 32 * 9, 5)
    got = gather.winner_scatter_ordered([torch.from_numpy(g)], torch.from_numpy(obj), rows, (3,),
                                        32, 32 * 9, 5)
    assert np.array_equal(got.numpy(), want)
    # the order matters at these magnitudes: a sum in lane order rounds apart
    plain = gather.winner_scatter_plain(torch.from_numpy(g), torch.from_numpy(obj), rows)
    assert not torch.equal(plain, got)


def test_the_wrappers_check_their_arguments():
    table, ints, obj, g = map(torch.from_numpy, _inputs(37))
    widths = gather.WIDTHS
    grads = [g[:, :w].contiguous().reshape(sh)
             for w, sh in zip(widths, gather._field_shapes(B, widths))]
    with pytest.raises(RuntimeError, match="CUDA"):  # outside the rehearsal: CUDA only
        gather._launch_gather(table, obj, ints, widths)
    with pytest.raises(RuntimeError, match="CUDA"):
        gather._launch_scatter(grads, obj, 37, widths)
    with _build.host_rehearsal():
        for bad in (table.double(), table.t(), table[None]):
            with pytest.raises(ValueError, match="table"):
                gather._launch_gather(bad, obj, ints, widths)
        with pytest.raises(ValueError, match="obj"):
            gather._launch_gather(table, obj.long(), ints, widths)
        with pytest.raises(ValueError, match="rows"):
            gather._launch_gather(table, obj, ints[1:], widths)
        for bad_widths in ((), widths[:-1], (0,) + widths, (1,) * F):
            with pytest.raises(ValueError, match="widths"):
                gather._launch_gather(table, obj, ints, bad_widths)
        with pytest.raises(ValueError, match="gradients"):
            gather._launch_scatter(grads[1:], obj, 37, widths)
        with pytest.raises(ValueError, match="grad"):
            gather._launch_scatter([grads[4]] + grads[1:], obj, 37, widths)  # (B,) for (B, 3)
        with pytest.raises(ValueError, match="obj"):
            gather._launch_scatter(grads, obj[1:], 37, widths)


class _FakeKernel:
    """Stands for a kernel of the loaded library: records its calls."""

    def __init__(self, calls, name):
        self.argtypes, self.restype, self.calls, self.name = None, None, calls, name

    def __call__(self, *args):
        self.calls.append(self.name)
        if self.name == "scatter":
            args[9]._obj.value = 1  # the mode it ran: the tile
        return 0


def test_winner_gather_on_a_device_tensor_never_calls_the_plain_version(monkeypatch):
    """A tensor off the CPU launches the kernels or raises: without a card
    (meta tensors) the launch raises, and with the launch stood in for it
    runs the kernels' wrappers, counted, and never the plain versions."""
    def plain(*args, **kw):
        raise AssertionError("the plain version ran for a tensor off the CPU")

    monkeypatch.setattr(gather, "winner_gather_plain", plain)
    monkeypatch.setattr(gather, "winner_scatter_plain", plain)
    table = torch.empty((37, F), device="meta", requires_grad=True)
    obj = torch.empty((B,), dtype=torch.int32, device="meta")
    ints = torch.empty((37, 3), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        gather.winner_gather(table, obj, ints, widths=gather.WIDTHS)

    calls = []
    lib = type("Lib", (), {})()
    lib.rt_winner_gather = _FakeKernel(calls, "gather")
    lib.rt_winner_scatter = _FakeKernel(calls, "scatter")
    monkeypatch.setattr(_build, "check_device", lambda dev: None)
    monkeypatch.setattr(_build, "stream_of", lambda dev: None)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    _build.reset_launches()
    got = gather.winner_gather(table, obj, ints, widths=gather.WIDTHS,
                               grad_cols=gather.GRAD_COLUMNS)
    torch.autograd.grad(got[0].sum(), table)
    assert calls == ["gather", "scatter"]
    assert dict(_build.LAUNCHES) == {"winner_gather": 1, "winner_scatter": 1}
    _build.reset_launches()


def test_the_pack_is_made_once_a_scene_object():
    scene, _ = examples.iow_final_scene(side=5)
    params = diff.extract_params(scene).map(lambda v: v.clone().requires_grad_(True))
    s = diff.apply_params(scene, params)
    a = gather.winner_table(s)
    assert gather.winner_table(s) is a and a.grad_cols == gather.GRAD_COLUMNS
    assert a.table.shape == (scene.capacity, F) and a.ints.shape == (scene.capacity, 3)
    with torch.no_grad():
        b = gather.winner_table(s)  # another grad mode: packed again
        assert b is not a and not b.table.requires_grad
    assert gather.winner_table(s) is not b  # ... and back
    assert gather.winner_table(s.replace()) is not gather.winner_table(s)  # another object
    kept = gather.winner_table(s)
    with torch.no_grad():
        s.color.add_(0.0)  # an in-place write
    assert gather.winner_table(s) is not kept
    rot = s.replace(rotation=s.rotation.clone().requires_grad_(True))
    assert gather.winner_table(rot).grad_cols == F

    # requires_grad_() writes nothing (no new _version) but packs again: the
    # kept pack has no path to a field that needed no gradient when packed
    plain = s.replace(rotation=s.rotation.detach().clone(), color=s.color.detach().clone())
    before = gather.winner_table(plain)
    assert before.grad_cols == gather.GRAD_COLUMNS
    plain.color.requires_grad_(True)
    plain.rotation.requires_grad_(True)
    after = gather.winner_table(plain)
    assert after is not before and after.grad_cols == F
    obj = torch.arange(-1, scene.capacity, dtype=torch.int32)
    picked = after.gather(obj)
    d_color, d_rot = torch.autograd.grad(
        picked["color"].sum() + picked["rotation"].sum(), [plain.color, plain.rotation])
    counts = torch.bincount(obj.clamp_min(0).long(), minlength=scene.capacity).float()
    assert torch.equal(d_color, counts[:, None].expand_as(d_color))
    assert torch.equal(d_rot, counts[:, None, None].expand_as(d_rot))

    # the pack's backward splits the table's gradient into the fields, and
    # every field reads as the scene holds it
    obj = torch.arange(-1, scene.capacity, dtype=torch.int32)
    got = gather.winner_table(s).gather(obj)
    safe = obj.clamp_min(0).long()
    for name, _ in gather.FLOAT_FIELDS:
        assert torch.equal(got[name].detach(), getattr(s, name)[safe].detach()), name
    for name in gather.INT_FIELDS:
        assert torch.equal(got[name], getattr(s, name)[safe]), name
    assert not got["rotation"].requires_grad
    loss = sum((got[name] * (k + 1)).sum() for k, (name, _) in enumerate(gather.FLOAT_FIELDS[:9]))
    grads = torch.autograd.grad(loss, [v for _, v in params.items()][:9])
    counts = torch.bincount(safe, minlength=scene.capacity).float()
    for k, ((name, _), gr) in enumerate(zip(gather.FLOAT_FIELDS, grads)):
        want = (k + 1) * counts.reshape((-1,) + (1,) * (gr.dim() - 1)).expand_as(gr)
        assert torch.equal(gr, want), name


@pytest.mark.parametrize("soft", [0.0, 0.03])
def test_the_step_through_the_rehearsed_kernels(monkeypatch, soft):
    """A banded gradient step on the CPU with the gather's forward and
    backward run by the kernel source as host C++: the loss bit for bit the
    plain route's, every gradient within 1e-6 of its field's max |g|, one
    gather and one scatter launched for each call of ``intersect_diff``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")
    scene, cam = examples.iow_final_scene(side=5)
    cfg = RenderConfig(width=16, height=8, spp=2, max_bounces=3,
                       intersector="pallas").for_scene(scene)
    cfg = dataclasses.replace(cfg, soft_edges=soft)
    pert = scene.replace(color=scene.color * 0.8 + 0.1)
    target = torch.full((cfg.height, cfg.width, 3), 0.5)
    p = diff.extract_params(pert)

    def step():
        """The second call of a new function: the first also probes the
        RI slots (a forward without gradient)."""
        vg = diff.banded_value_and_grad(pert, cam, cfg, grad_bands=2, device="cpu")
        vg(p, target)
        calls.clear()
        _build.reset_launches()
        return vg(p, target)

    calls = []
    loss_plain, grads_plain = step()

    def rehearsed_gather(table, obj, ints, widths):
        with _build.host_rehearsal():
            return gather._launch_gather(table, obj, ints, widths)

    def rehearsed_scatter(grads, obj, rows, widths):
        with _build.host_rehearsal():
            return gather._launch_scatter(grads, obj, rows, widths)[0]

    real = fastpath.intersect_diff

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(gather, "_gather", rehearsed_gather)
    monkeypatch.setattr(gather, "_scatter", rehearsed_scatter)
    monkeypatch.setattr(fastpath, "intersect_diff", counted)
    loss, grads = step()
    launches = dict(_build.LAUNCHES)
    _build.reset_launches()
    assert len(calls) > 0
    assert launches == {"winner_gather": len(calls), "winner_scatter": len(calls)}
    assert float(loss) == float(loss_plain)
    for name, want in grads_plain.items():
        scale = float(want.abs().max())
        assert float((getattr(grads, name) - want).abs().max()) <= 1e-6 * max(scale, 1e-30), name


def test_the_step_returns_a_contiguous_gradient_a_field():
    """The pack's backward hands each field its gradient as a strided view of
    the table's; ``value_and_grad_loss`` returns each as its own contiguous
    tensor, which an ``all_reduce`` over a process group needs."""
    scene, cam = examples.iow_final_scene(side=4)
    cfg = RenderConfig(width=8, height=4, spp=1, max_bounces=2,
                       intersector="pallas").for_scene(scene)
    _, grads = diff.value_and_grad_loss(diff.extract_params(scene), scene, cam, cfg,
                                        torch.full((4, 8, 3), 0.5), device="cpu")
    for name, g in grads.items():
        assert g.is_contiguous() and g.storage_offset() == 0, name
    assert len({g.untyped_storage().data_ptr() for _, g in grads.items()}) == len(grads.items())


def test_the_tangent_is_the_gather_of_the_tangent_table(monkeypatch):
    """Forward-mode AD: ``torch.func.jvp`` through ``winner_gather`` gives
    each field's tangent as the gather of the tangent table, by the same
    kernel (rehearsed on the host where there is a g++; counted as
    ``winner_gather``, one launch for the primal and one for the tangent),
    and no tangent (zeros) to the fields past ``grad_cols`` and the int
    columns."""
    table, ints, obj, _ = (torch.from_numpy(x) for x in _inputs(37, seed=3))
    tangent = torch.from_numpy(np.random.default_rng(4).normal(size=tuple(table.shape)).astype(
        np.float32))
    if shutil.which("g++") is not None:
        def launch(*args, widths):
            with _build.host_rehearsal():
                outs, iouts = gather._launch_gather(*args, widths)
            return (*outs, *iouts)

        def rehearsed(t, o, i, widths):  # the kernel's route, on the tensors themselves
            got = _build.constant(lambda *a: launch(*a, widths=widths), t, o, i)
            return list(got[:len(widths)]), list(got[len(widths):])

        monkeypatch.setattr(gather, "_gather", rehearsed)
    _build.reset_launches()
    out, tan = torch.func.jvp(
        lambda t: gather.winner_gather(t, obj, ints, widths=gather.WIDTHS,
                                       grad_cols=gather.GRAD_COLUMNS), (table,), (tangent,))
    launches = dict(_build.LAUNCHES)
    _build.reset_launches()
    if shutil.which("g++") is not None:
        assert launches == {"winner_gather": 2}
    want = torch.index_select(tangent, 0, obj.clamp_min(0).long())
    at = 0
    for k, w in enumerate(gather.WIDTHS):
        got = tan[k].reshape(B, w)
        if at < gather.GRAD_COLUMNS:
            assert torch.equal(got, want[:, at:at + w])
        else:
            assert not bool(got.any())
        at += w
    assert all(not bool(t.any()) for t in tan[len(gather.WIDTHS):])
