"""LBVH build on the scene's device, and the 30-bit Morton codes it sorts by.

Pipeline (vectorized torch, no host round-trips):
  1. per-object world AABBs including the motion sweep,
  2. 30-bit Morton codes of the centroids normalized to the scene AABB,
  3. sort by (morton, AABB size, index): two stable sorts, by size and then
     by code, give the JAX package's ``lexsort((size, codes))`` order,
  4. Karras 2012 internal-node range and split, every node computed
     independently,
  5. internal-node AABBs as range min/max over the sorted leaf AABBs through
     a sparse table (log2 N levels): a Karras node's AABB is exactly the AABB
     of its contiguous sorted-leaf range.

Node layout (SoA, 2N-1 nodes): internal nodes occupy [0, N-2] with node 0 the
root; leaf k is node (N-1) + k and stores the *original* object id.  The
``parent`` array drives the stackless traversal (``bvh.traverse``).  The
layout equals the JAX package's bit for bit in ``left``, ``right``,
``parent`` and ``obj_id``, and in the boxes (min/max of the same float32
values).

Codes are held in int64 and masked to 32 bits after every multiply, which
reproduces uint32 wrap-around arithmetic.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracing_tests_tpu_torch.scene.types import Scene, _TensorStruct

_U32 = 0xFFFFFFFF


@dataclasses.dataclass
class LBVH(_TensorStruct):
    bb_min: torch.Tensor  # (2N-1, 3) f32
    bb_max: torch.Tensor  # (2N-1, 3) f32
    left: torch.Tensor  # (2N-1,) i32 child node index (-1 for leaves)
    right: torch.Tensor  # (2N-1,) i32
    parent: torch.Tensor  # (2N-1,) i32 (-1 for the root)
    obj_id: torch.Tensor  # (2N-1,) i32 original object index (-1 for internal nodes)

    @property
    def n_leaves(self) -> int:
        return (self.left.shape[0] + 1) // 2

    @property
    def n_internal(self) -> int:
        return self.n_leaves - 1

    @property
    def device(self):
        return self.left.device


def _expand_bits(v):
    """Insert two zero bits after each of the low 10 bits."""
    v = ((v * 0x00010001) & _U32) & 0xFF0000FF
    v = ((v * 0x00000101) & _U32) & 0x0F00F00F
    v = ((v * 0x00000011) & _U32) & 0xC30C30C3
    v = ((v * 0x00000005) & _U32) & 0x49249249
    return v


def morton3d(xyz01):
    """30-bit Morton code (int64 tensor) of points in [0,1]^3."""
    q = torch.clamp(xyz01 * 1024.0, 0.0, 1023.0).to(torch.int64)
    x = _expand_bits(q[..., 0])
    y = _expand_bits(q[..., 1])
    z = _expand_bits(q[..., 2])
    return (x << 2) | (y << 1) | z


def _clz32(x):
    """Count of leading zeros of uint32 values held in int64 (32 for 0):
    an exact binary search on the bit length."""
    length = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        up = (x >> s) > 0
        length = length + torch.where(up, s, 0)
        x = torch.where(up, x >> s, x)
    return 32 - (length + (x > 0).to(x.dtype))


def _make_delta(codes, n: int):
    """Karras delta(i, j): common-prefix length of sorted codes, with equal
    codes told apart by position (delta = 32 + clz(i ^ j)); -1 off-range."""

    def delta(i, j):
        valid = (j >= 0) & (j < n)
        jc = j.clamp(0, n - 1)
        x = codes[i] ^ codes[jc]
        d = torch.where(x == 0, 32 + _clz32(i ^ jc), _clz32(x))
        return torch.where(valid, d, -1)

    return delta


def build_lbvh(scene: Scene) -> LBVH:
    """Build the LBVH over all ``capacity`` objects, on the scene's device.
    Padding rows collapse to a degenerate box at the scene-max corner (zero
    surface; their leaves are also guarded by ``valid`` at intersection
    time)."""
    n = scene.capacity
    assert n >= 2, "LBVH needs at least 2 objects"
    dev = scene.device
    lo, hi = scene.world_aabbs()
    valid = scene.valid[:, None]
    big = torch.amax(torch.where(valid, hi, -torch.inf), dim=0)
    lo = torch.where(valid, lo, big)
    hi = torch.where(valid, hi, big)

    scene_lo = torch.amin(lo, dim=0)
    scene_hi = torch.amax(hi, dim=0)
    centroid = (lo + hi) * 0.5
    extent = torch.clamp_min(scene_hi - scene_lo, 1e-12)
    codes = morton3d((centroid - scene_lo) / extent)  # (N,) uint32 in int64

    # Sorted order: morton ascending, then AABB size, then index.  The size
    # is summed left to right, as the JAX package's three-term sum is.
    ext = hi - lo
    size = (ext[:, 0] + ext[:, 1]) + ext[:, 2]
    order = torch.argsort(size, stable=True)
    order = order[torch.argsort(codes[order], stable=True)]
    codes_s = codes[order]
    lo_s, hi_s = lo[order], hi[order]

    n_int = n - 1
    i = torch.arange(n_int, dtype=torch.int64, device=dev)
    delta = _make_delta(codes_s, n)

    d = torch.where(delta(i, i + 1) > delta(i, i - 1), 1, -1)
    delta_min = delta(i, i - d)

    # Range-length upper bound by doubling (max length n => ~log2(n) + 2 steps).
    n_dbl = max(2, n.bit_length() + 1)
    lmax = torch.full((n_int,), 2, dtype=torch.int64, device=dev)
    for _ in range(n_dbl):
        lmax = torch.where(delta(i, i + lmax * d) > delta_min, lmax * 2, lmax)

    # Binary-search the exact far end j = i + l*d.
    length = torch.zeros_like(i)
    for s in range(n_dbl + 1):
        t = lmax >> (s + 1)
        probe = delta(i, i + (length + t) * d) > delta_min
        length = torch.where((t > 0) & probe, length + t, length)
    j = i + length * d

    # Split search: the highest position sharing more than delta(i, j) bits.
    delta_node = delta(i, j)
    split = torch.zeros_like(i)
    t = (length + 1) // 2
    for _ in range(n_dbl + 1):
        probe = delta(i, i + (split + t) * d) > delta_node
        split = torch.where((t >= 1) & probe, split + t, split)
        t = torch.where(t > 1, (t + 1) // 2, 0)
    gamma = i + split * d + torch.clamp_max(d, 0)

    leaf_base = n_int  # leaf k lives at node leaf_base + k
    first, last = torch.minimum(i, j), torch.maximum(i, j)
    left_child = torch.where(first == gamma, leaf_base + gamma, gamma)
    right_child = torch.where(last == gamma + 1, leaf_base + gamma + 1, gamma + 1)

    total = 2 * n - 1
    minus_one = lambda: torch.full((total,), -1, dtype=torch.int32, device=dev)  # noqa: E731
    left, right, parent, obj_id = minus_one(), minus_one(), minus_one(), minus_one()
    left[:n_int] = left_child.to(torch.int32)
    right[:n_int] = right_child.to(torch.int32)
    parent[left_child] = i.to(torch.int32)
    parent[right_child] = i.to(torch.int32)
    obj_id[leaf_base:] = order.to(torch.int32)

    bb_lo_int, bb_hi_int = _range_aabb(lo_s, hi_s, first, last)
    return LBVH(bb_min=torch.cat([bb_lo_int, lo_s]), bb_max=torch.cat([bb_hi_int, hi_s]),
                left=left, right=right, parent=parent, obj_id=obj_id)


def _range_aabb(lo_s, hi_s, first, last):
    """Min/max of leaf AABBs over inclusive index ranges: sparse table
    (log2 N levels), then two overlapping power-of-two windows per query.

    The window's level is ``floor(log2(float32 length))``, as the JAX package
    computes it; it is exact below 2^20 leaves, where float32 keeps
    ``log2(2^k - 1)`` below k."""
    n = lo_s.shape[0]
    levels = max(1, n.bit_length())
    lo_tab, hi_tab = [lo_s], [hi_s]
    for k in range(1, levels):
        half = 1 << (k - 1)
        prev_lo, prev_hi = lo_tab[-1], hi_tab[-1]
        pad_lo = prev_lo[-1:].expand(half, 3)
        pad_hi = prev_hi[-1:].expand(half, 3)
        lo_tab.append(torch.minimum(prev_lo, torch.cat([prev_lo[half:], pad_lo])))
        hi_tab.append(torch.maximum(prev_hi, torch.cat([prev_hi[half:], pad_hi])))
    lo_tab = torch.stack(lo_tab)  # (L, N, 3)
    hi_tab = torch.stack(hi_tab)

    length = (last - first + 1).to(torch.float32)
    k = torch.floor(torch.log2(torch.clamp_min(length, 1.0))).to(torch.int64)
    b = last - (1 << k) + 1
    lo_q = torch.minimum(lo_tab[k, first], lo_tab[k, b])
    hi_q = torch.maximum(hi_tab[k, first], hi_tab[k, b])
    return lo_q, hi_q
