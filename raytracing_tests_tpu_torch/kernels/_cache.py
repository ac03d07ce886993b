"""Bounded FIFO caches keyed on the identity and version of tensors.

The render path packs a scene into tables on every ``render_uber`` call: the
probe cut (``sweep2.probe_relevant_rows``), the accel and camera vector
(``uber._scene_accel``) and the atlas (``uber.packed_atlas``).  A scene that is
rendered again unchanged gets the tables of the first call from here.

An entry holds strong references to the tensors its value was computed from,
with each one's ``_version`` at the time.  A lookup hits only when every
tensor ``is`` the stored one (the references keep them alive, so equal ids
prove identity) and none has been written in place since (``_version`` counts
every in-place write through PyTorch: ``copy_``, ``add_``, an optimizer step,
an indexed assignment).  The tensors of the value itself that a caller could
write into (``watch``) are stamped the same way, so a caller that wrote into a
returned table gets a rebuild, not the written table.

Only tensors that outlive the call are worth an entry: a caller that passes
``deps=None`` (``render_uber`` for a scene it had to copy to its device) builds
and stores nothing.  ``counts`` tallies hits, misses and such bypasses.

The checks read host-side attributes only and never synchronise with the
card.  Their limit: a write that bypasses the version counter (through
``.data``, a numpy view of a CPU tensor, or a pointer handed to other code) is
not seen.  Inference tensors carry no version counter and are never cached.
"""

from __future__ import annotations

import collections
from typing import Callable, Optional, Sequence

import torch


def _stamp(tensors: Sequence[torch.Tensor]):
    return tuple((t, t._version) for t in tensors)


def _unchanged(stamp, tensors: Sequence[torch.Tensor]) -> bool:
    return len(stamp) == len(tensors) and all(
        t is s and t._version == v for (s, v), t in zip(stamp, tensors))


class TensorCache:
    """A FIFO of at most ``size`` values, each keyed on a tuple of tensors (by
    identity and version) and a tuple of hashable extras.  ``watch(value)``
    names the value's own tensors that must stay unwritten for it to be
    served."""

    def __init__(self, size: int, watch: Callable = lambda value: ()):
        self.size = size
        self.watch = watch
        self.entries: dict = {}
        self.counts: collections.Counter = collections.Counter()

    def __len__(self) -> int:
        return len(self.entries)

    def clear(self) -> None:
        self.entries.clear()

    def cached(self, deps: Optional[Sequence[torch.Tensor]], extra: tuple, build: Callable):
        """The value stored for exactly these tensors and ``extra``, none of
        them (nor of the value's watched tensors) written since; else
        ``build()``, stored (the oldest entry dropped when full; a stale one
        dropped at once; inference tensors never stored).  With
        ``deps=None``, ``build()`` alone."""
        if deps is None:
            self.counts["bypass"] += 1
            return build()
        key = tuple(map(id, deps)) + tuple(extra)
        entry = self.entries.get(key)
        if entry is not None:
            dep_stamp, value, own_stamp = entry
            if _unchanged(dep_stamp, deps) and _unchanged(own_stamp, self.watch(value)):
                self.counts["hit"] += 1
                return value
            del self.entries[key]
        self.counts["miss"] += 1
        value = build()
        own = self.watch(value)
        if not any(t.is_inference() for t in (*deps, *own)):
            while len(self.entries) >= self.size:
                self.entries.pop(next(iter(self.entries)))
            self.entries[key] = (_stamp(deps), value, _stamp(own))
        return value
