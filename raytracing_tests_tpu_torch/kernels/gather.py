"""The gradient path's winner gather: each lane's row of the scene's fields,
with a hand-written backward.

No TPU kernel stands behind this module: the JAX package's differentiable
recompute gathers the winner's row of each scene field per lane
(``diff/fastpath.py:141-145``, ``:200-208``: ``scene.position[safe]`` and the
others), and XLA fuses those gathers and their scatter-add transpose.  Their
counterpart here is one pair of hand-written CUDA kernels
(``csrc/gather.cu``): ``winner_gather``'s forward reads every field in one
launch (counted as ``winner_gather``), one thread a lane over the tables
staged in shared memory, each field into its own contiguous tensor, so that
the recompute's elementwise kernels read dense rows; its backward sums every
field's gradient into the table in one cooperative launch
(``winner_scatter``): a warp's lanes of one row by a tree of shuffles, a
block's chunks into its own tile, the blocks' tiles in block order after a
grid barrier.  It adds by no atomic, so the many lanes of one object (the
ground sphere owns half of them) neither serialise as ``index_add_``'s do
nor add in an order that changes from run to run: the same inputs give the
same bits on every launch, in the order ``winner_scatter_ordered`` spells
out.

The fields are packed once a scene object (``winner_table``): one float32
table (N, F) of the nine trainable fields (``GRAD_COLUMNS`` = 17 columns, in
``FLOAT_FIELDS`` order) and the rotation (9 columns), and one int32 table
(N, 3) of ``INT_FIELDS``, which rides in the gather's launch and carries no
gradient.  The rotation comes out without gradient where it needs none.
The pack's backward is the split of the table's gradient into the fields.

``winner_gather_plain`` is the same gather in plain PyTorch (``index_select``,
whose backward is ``index_add_``), and ``winner_scatter_plain`` the backward
(``index_add_``); ``winner_scatter_ordered`` is the backward summed in the
kernel's order (for tests, at the geometry ``scatter_plan`` gives).
``winner_gather`` uses the first two only for tensors that lie on the CPU;
for CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from raytracing_tests_tpu_torch.kernels import _build
from raytracing_tests_tpu_torch.kernels._cache import _stamp, _unchanged

# (field, columns) of the float table, the trainable fields first
FLOAT_FIELDS = (("position", 3), ("scale", 3), ("delta_position", 3), ("color", 3),
                ("refractive_index", 1), ("refractivity", 1), ("reflectivity", 1),
                ("scatter_refract", 1), ("scatter_reflect", 1), ("rotation", 9))
GRAD_COLUMNS = 17  # the nine trainable fields' columns (diff.params.FLOAT_FIELDS)
INT_FIELDS = ("obj_type", "texture_index", "emissive")
# Shared memory the backward's tile mode may take: its (N, G) floats and two
# buffers of a batch's rows and gradients (``csrc/gather.cu``).  488 rows x
# 17 columns take 109 KB (batches of 512 lanes), bvh1k's 1 032 rows x 26
# columns 163 KB (256 lanes); above it each block adds into its tile in the
# scratch (the global mode).
SMEM_BUDGET = 200 * 1024
# Shared memory the gather's staged tables may take (with a warp's stage of
# the widest field): 488 rows 93 KB, 1 032 rows 160 KB; above it the gather
# reads the tables through the L1 and L2 caches.
GATHER_SMEM_BUDGET = 192 * 1024
MAX_FIELDS = 16  # fields of the float table, and int columns (csrc/gather.cu)
WARP = 32  # a warp's lanes on the card; the host rehearsal's warps have one


WIDTHS = tuple(w for _, w in FLOAT_FIELDS)


@dataclasses.dataclass
class WinnerTable:
    """A scene's fields packed for ``winner_gather``: ``table`` (N, F)
    float32 in ``FLOAT_FIELDS`` order, ``ints`` (N, 3) int32 in
    ``INT_FIELDS`` order, and ``grad_cols``: the leading columns whose
    fields may need a gradient (``GRAD_COLUMNS``, or every column where the
    rotation needs one too)."""

    table: torch.Tensor
    ints: torch.Tensor
    grad_cols: int

    def gather(self, obj) -> dict:
        """{field: each lane's row at max(obj, 0)} for every packed field, by
        one ``winner_gather``: each field its own contiguous tensor, the
        rotation (B, 3, 3), the one-column fields (B,), ``emissive`` bool."""
        got = winner_gather(self.table, obj, self.ints, widths=WIDTHS,
                            grad_cols=self.grad_cols)
        names = [f for f, _ in FLOAT_FIELDS] + list(INT_FIELDS)
        out = dict(zip(names, got))
        out["rotation"] = out["rotation"].view(-1, 3, 3)
        out["emissive"] = out["emissive"] != 0
        return out


def _sources(scene):
    return [getattr(scene, f) for f, _ in FLOAT_FIELDS] + [getattr(scene, f) for f in INT_FIELDS]


def pack_table(scene) -> WinnerTable:
    """The scene's fields as one ``WinnerTable`` (a ``cat`` and a
    ``stack``; differentiable with respect to the float fields)."""
    n = scene.capacity
    table = torch.cat([getattr(scene, f).reshape(n, w) for f, w in FLOAT_FIELDS], dim=1)
    ints = torch.stack([getattr(scene, f).to(torch.int32) for f in INT_FIELDS], dim=1)
    grad_cols = table.shape[1] if scene.rotation.requires_grad else GRAD_COLUMNS
    return WinnerTable(table, ints, grad_cols)


def winner_table(scene) -> WinnerTable:
    """``pack_table(scene)``, packed once a scene object: kept on the scene
    for as long as every field is the same tensor, unwritten (by its
    ``_version``) and with the same ``requires_grad`` (which
    ``requires_grad_()`` sets without a write), and autograd's grad mode is
    the one it was packed under.
    The gradient path hands one scene object to every pop of a band
    (``diff.train._band`` and ``render_loss`` make it), so a band packs
    once.  The pack's autograd nodes save no tensor, so a backward through
    a kept pack may run more than once."""
    deps = _sources(scene)
    if any(t.is_inference() for t in deps):
        return pack_table(scene)
    key = (torch.is_grad_enabled(), tuple(t.requires_grad for t in deps))
    memo = scene.__dict__.get("_winner_table")
    if memo is not None and memo[0] == key and _unchanged(memo[1], deps):
        return memo[2]
    table = pack_table(scene)
    scene.__dict__["_winner_table"] = (key, _stamp(deps), table)
    return table


def winner_gather_plain(table, obj, ints):
    """Plain PyTorch version of the forward: ``index_select`` of ``table``
    and of ``ints`` at max(obj, 0); autograd's backward of it is
    ``index_add_``.  -> (out, int out)."""
    safe = obj.clamp_min(0).long()
    return torch.index_select(table, 0, safe), torch.index_select(ints, 0, safe)


def winner_scatter_plain(grad_out, obj, rows: int):
    """Plain PyTorch version of the backward: zeros (rows, F) with the rows
    of ``grad_out`` (B, F) added at max(obj, 0) by ``index_add_``."""
    out = torch.zeros((rows, grad_out.shape[1]), dtype=grad_out.dtype, device=grad_out.device)
    return out.index_add_(0, obj.clamp_min(0).long(), grad_out)


def winner_scatter_ordered(grads, obj, rows: int, widths, warp: int, block_lanes: int,
                           segments: int = 1):
    """The backward in ``csrc/gather.cu``'s order of sums, in plain PyTorch:
    ``grads`` one gradient a field (None where it has none), ``widths`` the
    fields' -> (rows, F) float32, 0 in the columns of the fields without a
    gradient.  Lanes fall into blocks of ``block_lanes`` (a multiple of
    ``warp``) and chunks of ``warp``; a chunk's lanes of one row are summed
    by a tree over their ranks in lane order (at step 1, 2, 4, ... the rank
    r = 0 mod 2 step takes r + step's partial sum); each block's tile sums
    its chunks' sums from 0 in chunk order; the output sums the tiles in
    ``segments`` runs of consecutive blocks, each from 0, and the runs' sums
    from 0 in order.  Equal bit for bit to the kernel at the same geometry
    (``scatter_plan``): float32 adds, one at a time, as the kernel does them."""
    B, F = obj.shape[0], sum(widths)
    cols, vals, at = [], [], 0
    for g, w in zip(grads, widths):
        if g is not None:
            cols.extend(range(at, at + w))
            vals.append(g.reshape(B, w))
        at += w
    like = next(g for g in grads if g is not None)
    out = torch.zeros((rows, F), dtype=torch.float32, device=like.device)
    if B == 0 or rows == 0:
        return out
    v = torch.cat(vals, dim=1).to(torch.float32)
    G, dev = v.shape[1], v.device

    def runs(key):
        """(sorted key, stable order, rank of each in its run of equal
        keys, each run's start)."""
        key, order = torch.sort(key, stable=True)
        first = torch.ones_like(key, dtype=torch.bool)
        first[1:] = key[1:] != key[:-1]
        starts = torch.nonzero(first).flatten()
        rank = torch.arange(key.numel(), device=dev) - starts[torch.cumsum(first, 0) - 1]
        return key, order, rank, starts

    lanes = torch.arange(B, device=dev)
    key, order, rank, starts = runs((lanes // warp) * rows + obj.long().clamp_min(0))
    v = v[order]
    size = torch.diff(torch.cat([starts, starts.new_tensor([B])]))
    size = torch.repeat_interleave(size, size)
    step = 1
    while step < warp:  # the tree, one step for all chunks at once
        at = torch.nonzero((rank % (2 * step) == 0) & (rank + step < size)).flatten()
        v[at] = v[at] + v[at + step]
        step *= 2
    sums, gkey = v[starts], key[starts]  # each chunk's sum of a row, by chunk then row
    block = gkey // rows // (block_lanes // warp)
    tkey, order, pos, _ = runs(block * rows + gkey % rows)  # chunk order kept in each run
    sums = sums[order]
    blocks = -(-B // block_lanes)
    tiles = torch.zeros((blocks * rows, G), dtype=torch.float32, device=dev)
    for p in range(int(pos.max()) + 1):  # each tile entry's p-th chunk sum
        at = torch.nonzero(pos == p).flatten()
        tiles[tkey[at]] = tiles[tkey[at]] + sums[at]
    tiles = tiles.view(blocks, rows, G)
    per = -(-blocks // segments)
    total = torch.zeros((rows, G), dtype=torch.float32, device=dev)
    for s in range(segments):
        run = torch.zeros_like(total)
        for q in range(s * per, min((s + 1) * per, blocks)):
            run = run + tiles[q]
        total = total + run
    out[:, cols] = total
    return out


def _sm_count(dev) -> int:
    """The card's streaming multiprocessors (1 for the host rehearsal)."""
    if dev.type != "cuda":
        return 1
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    got = _SMS.get(key)
    if got is None:
        got = _SMS[key] = torch.cuda.get_device_properties(key).multi_processor_count
    return got


_SMS: dict = {}


def scatter_plan(B: int, rows: int, G: int, device, blocks: int = 0) -> dict:
    """The backward's geometry for B lanes, ``rows`` rows and G columns with
    a gradient on ``device``: ``blocks`` (one a streaming multiprocessor, or
    as many as asked for, at most one a warp's chunk of lanes),
    ``block_lanes`` (each block's run of lanes, a multiple of the warp),
    ``warp`` (32 on the card, 1 in the host rehearsal) and ``segments`` (the
    final sum's runs of blocks: a warp a column, at most 32) ->
    ``winner_scatter_ordered``'s arguments."""
    device = torch.device(device)
    warp = 1 if device.type == "cpu" else WARP
    chunks = -(-B // warp)
    n = max(1, min(int(blocks) or _sm_count(device), chunks))
    per = -(-chunks // n) * warp
    return dict(blocks=-(-B // per) if B else 0, block_lanes=per, warp=warp,
                segments=max(1, min(G, 32)))


def _field_shapes(B: int, widths):
    return [(B, w) if w > 1 else (B,) for w in widths]


def _check(name, t, dtype, dims, dev):
    if t.dtype != dtype or t.dim() != dims or t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device} (contiguous: "
                         f"{t.is_contiguous()}), expected {dtype} with {dims} dimensions, "
                         f"contiguous on {dev}")


def _check_widths(widths, F: int):
    if not widths or min(widths) < 1 or sum(widths) != F or len(widths) > MAX_FIELDS:
        raise ValueError(f"widths {tuple(widths)}: at most {MAX_FIELDS} fields, each at least "
                         f"one column, summing to the table's {F}")


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr()
                                              for t in tensors])


def _launch_gather(table, obj, ints, widths, smem_budget: int = GATHER_SMEM_BUDGET):
    """Check the arguments and launch ``rt_winner_gather`` on the current
    stream -> (the fields' outputs (B, width) float32, (B,) where the width
    is 1; the int columns' outputs (B,) int32)."""
    return _launch_gather_routed(table, obj, ints, widths, smem_budget)[:2]


def _launch_gather_routed(table, obj, ints, widths, smem_budget: int = GATHER_SMEM_BUDGET):
    """``_launch_gather`` -> (its outputs, the route the kernel read the
    tables by: "shared" where they fit ``smem_budget`` bytes of shared
    memory, else "ldg")."""
    dev = table.device
    _check("table", table, torch.float32, 2, dev)
    _check("obj", obj, torch.int32, 1, dev)
    _check("ints", ints, torch.int32, 2, dev)
    (N, F), FI, B = table.shape, ints.shape[1], obj.shape[0]
    _check_widths(widths, F)
    if ints.shape[0] != N or FI > MAX_FIELDS:
        raise ValueError(f"ints {tuple(ints.shape)} for a table of {N} rows")
    _build.check_device(dev)
    outs = [torch.empty(sh, dtype=torch.float32, device=dev) for sh in _field_shapes(B, widths)]
    iouts = [torch.empty((B,), dtype=torch.int32, device=dev) for _ in range(FI)]
    fn = _build.load("gather").rt_winner_gather
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, p, ctypes.c_longlong, i, i, i, p, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
    staged = ctypes.c_int(-1)
    code = fn(table.data_ptr(), ints.data_ptr(), obj.data_ptr(), _pointers(outs),
              (ctypes.c_int * len(widths))(*widths), len(widths), _pointers(iouts), B, N, F, FI,
              _build.stream_of(dev), smem_budget, ctypes.byref(staged))
    _build.check(code, "rt_winner_gather")
    if B and N:
        _build.LAUNCHES["winner_gather"] += 1
    return outs, iouts, "shared" if staged.value == 1 else "ldg"


def _launch_scatter(grads, obj, rows: int, widths, smem_budget: int = SMEM_BUDGET,
                    blocks: int = 0):
    """Check the arguments and launch ``rt_winner_scatter`` on the current
    stream: ``grads`` one gradient a field (its output's shape), None where
    it has none, at ``scatter_plan``'s geometry (``blocks``: 0 for one a
    streaming multiprocessor) -> (grad_table (rows, F) float32, the mode:
    "tile" or "global")."""
    dev = obj.device
    _check("obj", obj, torch.int32, 1, dev)
    B = obj.shape[0]
    _check_widths(widths, sum(widths))
    if len(grads) != len(widths):
        raise ValueError(f"{len(grads)} gradients for {len(widths)} fields")
    for g, sh in zip(grads, _field_shapes(B, widths)):
        if g is not None:
            _check("grad", g, torch.float32, len(sh), dev)
            if tuple(g.shape) != sh:
                raise ValueError(f"grad {tuple(g.shape)}, expected {sh} for obj's {B} lanes")
    _build.check_device(dev)
    G = sum(w for g, w in zip(grads, widths) if g is not None)
    launch = bool(B and rows and G)
    # the kernel writes every entry; the scratch holds each block's tile
    plan = scatter_plan(B, rows, G, dev, blocks) if launch else dict(blocks=0, block_lanes=0,
                                                                       segments=1)
    out = (torch.empty if launch else torch.zeros)((rows, sum(widths)), dtype=torch.float32,
                                                   device=dev)
    partial = torch.empty((plan["blocks"] * rows * G,), dtype=torch.float32, device=dev)
    fn = _build.load("gather").rt_winner_scatter
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, i, p, p, ll, i, i, ll, p, p, i, ll, i, p]
        fn.restype = ctypes.c_int
    tile = ctypes.c_int(-1)
    code = fn(_pointers(grads), (ctypes.c_int * len(widths))(*widths), len(widths),
              obj.data_ptr(), out.data_ptr(), B, rows, out.shape[1], smem_budget,
              ctypes.byref(tile), partial.data_ptr(), plan["blocks"], plan["block_lanes"],
              plan["segments"], _build.stream_of(dev))
    _build.check(code, "rt_winner_scatter")
    if launch:
        _build.LAUNCHES["winner_scatter"] += 1
    return out, "tile" if tile.value == 1 else "global"


def _gather_plain(table, obj, ints, widths):
    """``_launch_gather``'s outputs by ``winner_gather_plain``."""
    out, iout = winner_gather_plain(table, obj, ints)
    outs = [v.reshape(sh).contiguous() for v, sh in zip(
        torch.split(out, list(widths), dim=1), _field_shapes(obj.shape[0], widths))]
    return outs, [c.contiguous() for c in iout.unbind(1)]


def _scatter_plain(grads, obj, rows: int, widths):
    """``_launch_scatter``'s table by ``winner_scatter_plain``."""
    B = obj.shape[0]
    like = next(g for g in grads if g is not None)
    grad_out = torch.cat([like.new_zeros((B, w)) if g is None else g.reshape(B, w)
                          for g, w in zip(grads, widths)], dim=1)
    return winner_scatter_plain(grad_out, obj, rows)


def _gather(table, obj, ints, widths):
    """The forward (and the tangent's gather): the plain version for CPU
    tensors, else the kernel."""
    if table.device.type == "cpu":
        return _gather_plain(table, obj, ints, widths)
    return _gather_kernel(table, obj, ints, widths)


def _gather_kernel(table, obj, ints, widths):
    """``_launch_gather`` on the tensors themselves under ``torch.func``
    (``_build.constant``)."""
    got = _build.constant(lambda *a: tuple(sum(_launch_gather(*a, widths), [])), table, obj, ints)
    return list(got[:len(widths)]), list(got[len(widths):])


def _scatter(grads, obj, rows: int, widths):
    """The backward: the plain version for CPU tensors, else the kernel."""
    if obj.device.type == "cpu":
        return _scatter_plain(grads, obj, rows, widths)
    return _scatter_kernel(grads, obj, rows, widths)


def _scatter_kernel(grads, obj, rows: int, widths):
    """``_launch_scatter``'s table on the tensors themselves under
    ``torch.func`` (``_build.constant``)."""
    present, back = _build.given(grads)
    return _build.constant(lambda o, *x: _launch_scatter(back(x), o, rows, widths)[0], obj,
                           *present)


class _WinnerGather(torch.autograd.Function):
    @staticmethod
    def forward(table, obj, ints, widths, grad_cols):
        outs, iouts = _gather(table, obj, ints, widths)
        return (*outs, *iouts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, obj, ints, widths, grad_cols = inputs
        ctx.save_for_backward(obj)
        ctx.save_for_forward(obj)
        ctx.rows, ctx.widths, ctx.ints = table.shape[0], widths, ints.shape[1]
        starts = [sum(widths[:k]) for k in range(len(widths))]
        ctx.grad_fields = sum(a < grad_cols for a in starts)
        ctx.mark_non_differentiable(*output[ctx.grad_fields:])
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, *grads):
        grads = [None if g is None else g.contiguous() for g in grads[:len(ctx.widths)]]
        if not ctx.needs_input_grad[0] or all(g is None for g in grads):
            return None, None, None, None, None
        (obj,) = ctx.saved_tensors
        return _scatter(grads, obj, ctx.rows, ctx.widths), None, None, None, None

    @staticmethod
    def jvp(ctx, t_table, *_):
        """The tangent of a gather is the gather of the tangent table: the
        same kernel (counted as ``winner_gather``) on ``t_table``, with no
        int columns; the fields from ``grad_cols`` on and the int columns
        get none."""
        (obj,) = ctx.saved_tensors
        n_out = len(ctx.widths) + ctx.ints
        if t_table is None:
            return (None,) * n_out
        no_ints = obj.new_empty((ctx.rows, 0))  # the tangent's gather reads no int column
        outs, _ = _gather(t_table.contiguous(), obj, no_ints, ctx.widths)
        return (*outs[:ctx.grad_fields], *[None] * (n_out - ctx.grad_fields))


def winner_gather(table, obj, ints, *, widths, grad_cols=None):
    """Each lane's row of ``table`` (N, F) at max(obj, 0), ``obj`` (B,) int,
    as one contiguous tensor a field: ``widths`` are the table's fields, in
    column order, and each comes out (B, width), (B,) where the width is 1.
    ``ints`` (N, FI) int32: each of its columns comes out too, (B,) int32,
    with no gradient.  -> the tuple of the fields' outputs and then the int
    columns'.  A lane whose winner is -1 reads row 0 and its gradient goes
    to row 0.

    Differentiable with respect to ``table``: the backward adds the lanes'
    gradients into their rows.  The fields that start at or after column
    ``grad_cols`` (None: none) come out non-differentiable, so their columns'
    gradient is zero: pass it only where those columns' sources need none
    (``WinnerTable`` does).  The gather reads the tables from shared memory
    where they fit ``GATHER_SMEM_BUDGET`` bytes, else through the caches.
    The backward's tile mode runs where the tile of the columns with a
    gradient fits ``SMEM_BUDGET`` bytes of shared memory, else its global
    mode; both sum in ``winner_scatter_ordered``'s order, so the same inputs
    give the same gradient bit for bit on every launch.

    CPU tensors go through ``winner_gather_plain`` and
    ``winner_scatter_plain``; CUDA tensors launch the kernels of
    ``csrc/gather.cu`` (counted as ``winner_gather`` and ``winner_scatter``)
    or raise.  Neither synchronises or reads on the host, so both can be
    captured in a CUDA graph."""
    widths = tuple(int(w) for w in widths)
    return _WinnerGather.apply(table, obj.to(torch.int32), ints, widths,
                               table.shape[1] if grad_cols is None else int(grad_cols))
