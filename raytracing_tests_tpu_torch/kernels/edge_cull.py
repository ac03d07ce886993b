"""The block table and block bound of the generic silhouette pass's exact cull.

The host side of ``csrc/edge_cull.cuh``, which ``csrc/sweep2g.cu``'s
silhouette instantiation (``sweep2g_nearest_edge``) walks: the valid rows of
a generic accel cut into blocks of at most ``BLOCK_ROWS`` consecutive rows of
one group, and into super-blocks of at most ``SUPER_ROWS``, each entry with a
ball that holds its rows' centres at every time omt in [0, 1] and the
constants of a lower bound of the metric (``block_table``, built once per
accel: ``edge_blocks``).  ``edge_block_bounds`` is that bound in plain
PyTorch, the kernel's float32 arithmetic operation for operation; the tests
hold it below every row's metric.  The argument is in the header's note.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracing_tests_tpu_torch.kernels.sweep2g import (
    GO_DPX, GO_DPZ, GO_PX, GO_PZ, GO_R00, GO_SX, GO_SZ, GO_VALID,
)

# Rows per block and per super-block (a multiple of it): the fastest sizes
# measured (PERF.md, section 6).
BLOCK_ROWS = 2
SUPER_ROWS = 16

# The table's columns (csrc/edge_cull.cuh EB_*): one entry of EB_COLS floats,
# four 16-byte loads.
EB_COLS = 16
EB_BCX, EB_BCY, EB_BCZ, EB_BR = 0, 1, 2, 3  # the ball: centre, radius rounded up
# least sigma_min(M)^2, largest K, largest rho, largest tau (the header's note)
EB_MU, EB_ERRK, EB_RHO, EB_TAU = 4, 5, 6, 7
EB_DPMAX = 8  # largest |dp| (0 for a static accel); columns 9-11 are unused
EB_ROW0, EB_NROWS, EB_SUB0, EB_NSUB = 12, 13, 14, 15  # rows; a super-block's blocks
# The bound's rounding margins: the metric per unit of K Lr^2, the last
# roundings, and the slack of the bound's own float32 arithmetic.
EB_EPS_G, EB_EPS_F = 2.0 ** -16, 2.0 ** -20
EB_SLACK = 2.0 ** -19
EB_DOWN, EB_UP = 1.0 - EB_SLACK, 1.0 + EB_SLACK


def _f32(x, up: bool):
    """float64 -> float32, rounded towards +inf (``up``) or -inf."""
    y = x.to(torch.float32)
    off = (y.to(torch.float64) < x) if up else (y.to(torch.float64) > x)
    return torch.where(off, torch.nextafter(
        y, torch.full_like(y, float("inf") if up else float("-inf"))), y)


def _block_rows(valid, gr: int, size: int):
    """Runs of valid rows inside one group of ``gr`` rows, cut into at most
    ``size`` rows -> (row0 (K,), nrows (K,)) int64 in row order."""
    n = valid.shape[0]
    r = torch.arange(n)
    new_run = r % gr == 0
    new_run[1:] |= valid[1:] != valid[:-1]
    run0 = torch.cummax(torch.where(new_run, r, torch.zeros_like(r)), dim=0).values
    row0 = r[(r - run0) % size == 0]
    nrows = torch.diff(torch.cat([row0, torch.tensor([n])]))
    keep = valid[row0]
    return row0[keep], nrows[keep]


def _entries(tab, row0, nrows, has_motion: bool):
    """The entries (K, EB_COLS) float32 of the row ranges [row0, row0 +
    nrows) of the float64 main table ``tab``, rounded to the safe side."""
    f64 = torch.float64
    K, n = row0.shape[0], tab.shape[0]
    centre = tab[:, GO_PX:GO_PZ + 1]
    dp = tab[:, GO_DPX:GO_DPZ + 1] if has_motion else torch.zeros((n, 3), dtype=f64)
    bid = torch.repeat_interleave(torch.arange(K), nrows)
    rows = row0[bid] + torch.arange(bid.shape[0]) - (torch.cumsum(nrows, 0) - nrows)[bid]

    def red(v, how):  # per-entry reduction of per-row values (rows,) or (rows, 3)
        idx = bid if v.dim() == 1 else bid[:, None].expand_as(v)
        out = torch.zeros((K,) + v.shape[1:], dtype=f64)
        return out.scatter_reduce(0, idx, v, how, include_self=False)

    slack = 1.0 + 1e-12  # the float64 roundings of the norms below
    p0, p1 = centre[rows], (centre - dp)[rows]
    bc = ((red(torch.minimum(p0, p1), "amin") + red(torch.maximum(p0, p1), "amax"))
          * 0.5).to(torch.float32)
    bcr = bc.to(f64)[bid]
    rad = torch.maximum((p0 - bcr).norm(dim=1), (p1 - bcr).norm(dim=1))
    eb = torch.zeros((K, EB_COLS), dtype=torch.float32)
    eb[:, EB_BCX:EB_BCZ + 1] = bc
    eb[:, EB_BR] = _f32(red(rad * slack, "amax"), up=True)
    eb[:, EB_DPMAX] = _f32(red(dp[rows].norm(dim=1) * slack, "amax"), up=True)
    eb[:, EB_ROW0] = row0.to(torch.float32)
    eb[:, EB_NROWS] = nrows.to(torch.float32)
    R = tab[rows, GO_R00:GO_R00 + 9].reshape(-1, 3, 3)
    sc = tab[rows, GO_SX:GO_SZ + 1]
    M = R.transpose(1, 2) / sc[:, :, None]  # diag(1/s) R^T
    good = torch.isfinite(M).flatten(1).all(dim=1) & (sc != 0.0).all(dim=1)
    M = torch.where(good[:, None, None], M, torch.eye(3, dtype=f64))
    lam = torch.linalg.eigvalsh(M @ M.transpose(1, 2))  # sigma^2, ascending
    lmax = lam[:, 2] * slack
    lmin = torch.clamp_min(lam[:, 0] - 1e-12 * lam[:, 2], 0.0)
    A = (1.0 / sc.abs()).amax(dim=1)
    errk = lmax.sqrt() * A + lmax * A / lmin.sqrt() + lmax
    lam = (lmax + lmin) * 0.5  # M^T M = lam I + E, |E| <= (lmax - lmin) / 2
    rho = (lmax - lmin) * 0.5 * slack / lam
    tau = EB_EPS_G * errk * slack / lam
    bad = lambda v: torch.where(good, v, torch.full_like(v, float("inf")))
    eb[:, EB_MU] = _f32(red(torch.where(good, lmin, torch.zeros_like(lmin)), "amin"), up=False)
    eb[:, EB_ERRK] = _f32(red(bad(errk), "amax"), up=True)
    eb[:, EB_RHO] = _f32(red(bad(rho), "amax"), up=True)
    eb[:, EB_TAU] = _f32(red(bad(tau), "amax"), up=True)
    return eb


def _block_table(accel, rows: int, super_rows: int):
    """``block_table`` with ``rows`` per block and ``super_rows`` (a multiple
    of ``rows``) per super-block."""
    tab = accel.otab[:accel.n_pad].detach().to("cpu", torch.float64)
    valid = tab[:, GO_VALID] > 0.0
    s0, sn = _block_rows(valid, accel.gr, super_rows)
    b0, bn = _block_rows(valid, accel.gr, rows)
    sup = _entries(tab, s0, sn, accel.has_motion)
    first = torch.searchsorted(b0, s0)
    sup[:, EB_SUB0] = (first + s0.shape[0]).to(torch.float32)
    sup[:, EB_NSUB] = (torch.searchsorted(b0, s0 + sn) - first).to(torch.float32)
    table = torch.cat([sup, _entries(tab, b0, bn, accel.has_motion)])
    return table.to(accel.device), int(s0.shape[0])


def block_table(accel):
    """The cull's block table of a generic ``Accel2G`` -> (table (n_super +
    n_blocks, EB_COLS) float32 on the accel's device, n_super): the
    super-blocks first, each naming its blocks (EB_SUB0, EB_NSUB), then the
    blocks.  Built on the host in float64 from the float32 tables and rounded
    to the safe side.  Blocks are runs of valid rows inside one group cut
    into at most ``BLOCK_ROWS`` rows, super-blocks the same runs cut into at
    most ``SUPER_ROWS``.  An entry's ball holds its rows' centres at omt = 0
    and 1 (the centre is p - omt dp, so at every omt between)."""
    return _block_table(accel, BLOCK_ROWS, SUPER_ROWS)


def _with_block_sizes(accel, rows: int, super_rows: int):
    """A copy of ``accel`` whose silhouette launches read a table of
    ``rows`` per block and ``super_rows`` per super-block (to measure other
    sizes; ``accel`` keeps its own)."""
    other = dataclasses.replace(accel)
    other.__dict__["_edge_blocks"] = ((other.otab.data_ptr(), other.otab._version),
                                      _block_table(other, rows, super_rows))
    return other


def edge_blocks(accel):
    """``block_table(accel)``, built once per accel: every silhouette launch
    on it reads the same tensor.  Kept on the accel and renewed when its
    ``otab`` is replaced or written in place."""
    key = (accel.otab.data_ptr(), accel.otab._version)
    memo = accel.__dict__.get("_edge_blocks")
    if memo is None or memo[0] != key:
        memo = accel.__dict__["_edge_blocks"] = (key, block_table(accel))
    return memo[1]


def edge_block_bounds(accel, rays):
    """The kernel's lower bound of the silhouette metric, per ray and entry
    of the block table, in plain PyTorch: ``rays`` (8, B) -> (B, n_super +
    n_blocks) float32, the kernel's float32 arithmetic operation for
    operation.  Every candidate row of an entry has a float32 metric (as the
    plain version and the kernel compute it) at or above its bound; +inf
    where no row of the entry can be a candidate (every centre behind the
    ray); -inf where a moving ray's omt lies outside [0, 1] (never culled).
    The kernel skips an entry only where the bound is strictly above the
    ray's best metric."""
    eb = edge_blocks(accel)[0]
    col = lambda c: eb[None, :, c]
    root = lambda x: x * torch.rsqrt(x)
    dx, dy, dz = (rays[k][:, None] for k in (3, 4, 5))
    dd = dx * dx + dy * dy + dz * dz
    inv_dd = 1.0 / dd
    qx, qy, qz = (rays[k][:, None] for k in (0, 1, 2))
    vx, vy, vz = col(EB_BCX) - qx, col(EB_BCY) - qy, col(EB_BCZ) - qz
    cx, cy, cz = vy * dz - vz * dy, vz * dx - vx * dz, vx * dy - vy * dx
    h = root((cx * cx + cy * cy + cz * cz) * inv_dd)
    vn = root(vx * vx + vy * vy + vz * vz)
    hl = h * EB_DOWN - EB_SLACK * vn - col(EB_BR)
    hl = torch.clamp_min(torch.where(torch.isnan(hl), torch.zeros_like(hl), hl), 0.0)  # fmaxf
    vn = vn * EB_UP
    dn = root(dd) * EB_UP
    vd = vx * dx + vy * dy + vz * dz
    vb = vn + col(EB_BR)
    lr = vb + 2.0 * col(EB_DPMAX)
    behind = -vd > dn * (col(EB_BR) + col(EB_RHO) * vb + col(EB_TAU) * lr + EB_SLACK * vn)
    m = col(EB_MU) * hl * hl * EB_DOWN
    out = m - 1.0 - EB_EPS_G * col(EB_ERRK) * lr * lr - EB_EPS_F * (1.0 + m)
    out = torch.where(behind, torch.full_like(out, float("inf")), out)
    if accel.has_motion:
        omt = rays[6][:, None]
        out = torch.where((omt >= 0.0) & (omt <= 1.0), out, torch.full_like(out, float("-inf")))
    return out
