"""BVH debug dump: the tree as text, and its depth statistics."""

from __future__ import annotations

import numpy as np

from raytracing_tests_tpu_torch.bvh.build import LBVH


def _np(x):
    return x.detach().cpu().numpy()


def format_tree(bvh: LBVH, max_depth: int = 32) -> str:
    """ASCII rendering of the LBVH: one line per node with AABB + object id."""
    left, obj_id = _np(bvh.left), _np(bvh.obj_id)
    right = _np(bvh.right)
    lo, hi = _np(bvh.bb_min), _np(bvh.bb_max)

    lines = []

    def walk(node: int, depth: int):
        if depth > max_depth:
            lines.append("  " * depth + "...")
            return
        tag = f"leaf obj={obj_id[node]}" if left[node] < 0 else f"node #{node}"
        bb = (
            f"[{lo[node][0]:.2f},{lo[node][1]:.2f},{lo[node][2]:.2f}]"
            f"..[{hi[node][0]:.2f},{hi[node][1]:.2f},{hi[node][2]:.2f}]"
        )
        lines.append("  " * depth + f"{tag} {bb}")
        if left[node] >= 0:
            walk(int(left[node]), depth + 1)
            walk(int(right[node]), depth + 1)

    walk(0, 0)
    return "\n".join(lines)


def tree_stats(bvh: LBVH) -> dict:
    """Depth and balance statistics (a check on the build's quality)."""
    left, right = _np(bvh.left), _np(bvh.right)
    depths = []
    stack = [(0, 0)]
    while stack:
        node, d = stack.pop()
        if left[node] < 0:
            depths.append(d)
        else:
            stack.append((int(left[node]), d + 1))
            stack.append((int(right[node]), d + 1))
    depths = np.asarray(depths)
    return {
        "n_leaves": int(len(depths)),
        "max_depth": int(depths.max()),
        "mean_depth": float(depths.mean()),
    }
