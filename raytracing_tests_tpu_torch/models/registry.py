"""Named-workload registry with a duplicate-name guard."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class Workload:
    """A runnable scenario.

    ``run(**overrides)`` returns a dict with at least ``image`` (H, W, 3)
    in [0, 1]; raytracing workloads also return ``depth``.  ``overrides``
    accepts width/height/spp/max_bounces/... render-config keys where
    applicable.
    """

    name: str
    description: str
    run: Callable[..., dict]
    category: str = "raytracing"
    reference: str = ""  # reference test the capability mirrors


_REGISTRY: Dict[str, Workload] = {}


def register(
    name: str, description: str, category: str = "raytracing", reference: str = ""
):
    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"duplicate workload name: {name}")
        _REGISTRY[name] = Workload(
            name=name,
            description=description,
            run=fn,
            category=category,
            reference=reference,
        )
        return fn

    return deco


def get_workload(name: str) -> Workload:
    if name not in _REGISTRY:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown workload '{name}' (known: {known})")
    return _REGISTRY[name]


def list_workloads(category: Optional[str] = None):
    ws = sorted(_REGISTRY.values(), key=lambda w: (w.category, w.name))
    if category:
        ws = [w for w in ws if w.category == category]
    return ws
