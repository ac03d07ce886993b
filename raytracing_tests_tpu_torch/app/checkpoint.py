"""Checkpoint and resume for the inverse-rendering loop.

Format: one ``.npz`` per checkpoint holding every array leaf of a tree
(``leaf_0``, ``leaf_1``, ...).  The tree's STRUCTURE is never serialised:
restoring takes a template (a freshly made ``TrainState`` for the same scene
and optimiser) and pours the leaves back into it.  No pickle: loading a
checkpoint from an untrusted directory can at worst give wrong numbers, never
run code.

A tree is a tensor, a numpy array, a Python number, None (no leaf), a list,
tuple or dict of trees, a dataclass of trees, or an object with
``tree_flatten() -> children`` and ``tree_unflatten(children) -> object``
(``diff.train.TrainState``: its params, Adam's step and moments per field,
and the step count).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

_SCALARS = (int, float, bool, np.generic)


def _children(tree):
    if hasattr(tree, "tree_flatten"):
        return list(tree.tree_flatten())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return list(tree.values())
    if isinstance(tree, (list, tuple)):
        return list(tree)
    raise TypeError(f"not a tree node: {type(tree).__name__}")


def _is_leaf(tree) -> bool:
    return isinstance(tree, (torch.Tensor, np.ndarray) + _SCALARS)


def tree_leaves(tree) -> list:
    """Every leaf of ``tree``, depth first in field / key / item order."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [tree]
    return [leaf for child in _children(tree) for leaf in tree_leaves(child)]


def _rebuild(template, children):
    if hasattr(template, "tree_unflatten"):
        return template.tree_unflatten(children)
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: c for f, c in zip(dataclasses.fields(template), children)})
    if isinstance(template, dict):
        return dict(zip(template.keys(), children))
    return type(template)(children)


def tree_unflatten(template, leaves):
    """``template``'s structure with ``leaves`` in place of its own: numpy
    arrays become tensors of the saved dtype on the template leaf's device,
    Python numbers stay numbers."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if _is_leaf(t):
            leaf = next(it)
            if isinstance(t, torch.Tensor):
                return torch.from_numpy(np.array(leaf)).to(t.device)
            if isinstance(t, np.ndarray):
                return np.array(leaf)
            return type(t)(np.asarray(leaf).item())
        return _rebuild(t, [build(c) for c in _children(t)])

    return build(template)


def _numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree) -> None:
    """Save every leaf of ``tree`` (a ``TrainState``, ``SceneParams``, ...)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{f"leaf_{i}": _numpy(x) for i, x in enumerate(tree_leaves(tree))})


def load_pytree(path: str, template):
    """Leaves saved by ``save_pytree`` in ``template``'s structure; the leaf
    count must match (e.g. a fresh ``TrainState`` for the same scene and
    optimiser)."""
    with np.load(path if path.endswith(".npz") else path + ".npz",
                 allow_pickle=False) as data:
        n = len(tree_leaves(template))
        if len(data.files) != n:
            raise ValueError(
                f"checkpoint has {len(data.files)} leaves, template expects {n} "
                f"(scene/optimizer mismatch?): {path}")
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    return tree_unflatten(template, leaves)


def latest_checkpoint(directory: str, prefix: str = "ckpt_"):
    """Path of the newest ``{prefix}{step}.npz`` in ``directory`` (or None)."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(".npz"):
            try:
                steps.append((int(name[len(prefix):-4]), name))
            except ValueError:
                continue
    if not steps:
        return None
    return os.path.join(directory, max(steps)[1])


def save_train_state(directory: str, state, step: int) -> str:
    path = os.path.join(directory, f"ckpt_{step}.npz")
    save_pytree(path, state)
    return path


def restore_train_state(directory: str, template):
    """(state, step) of the newest checkpoint restored into ``template``'s
    structure, or (None, 0) when the directory holds no checkpoint."""
    path = latest_checkpoint(directory)
    if path is None:
        return None, 0
    return load_pytree(path, template), int(os.path.basename(path)[5:-4])
