"""Nested-structure helpers (flatten / pack / map) over dict/list/tuple
trees: a copy of ``analytics_zoo_tpu/utils/nest.py``, which XShards and the
estimators use for ``{"x": ..., "y": ...}`` shard dicts. Plain Python, so
it works on numpy, pandas and torch leaves alike."""

from __future__ import annotations

from typing import Any, Callable, List, Sequence


def _is_leaf(x: Any) -> bool:
    return not isinstance(x, (dict, list, tuple))


def flatten(structure: Any) -> List[Any]:
    """Depth-first leaf list; dicts iterate in sorted-key order."""
    if _is_leaf(structure):
        return [structure]
    out: List[Any] = []
    if isinstance(structure, dict):
        for k in sorted(structure):
            out.extend(flatten(structure[k]))
    else:
        for v in structure:
            out.extend(flatten(v))
    return out


def pack_sequence_as(structure: Any, flat: Sequence[Any]) -> Any:
    """Inverse of :func:`flatten` against the shape of ``structure``."""
    flat = list(flat)

    def _pack(s):
        if _is_leaf(s):
            return flat.pop(0)
        if isinstance(s, dict):
            return {k: _pack(s[k]) for k in sorted(s)}
        vals = [_pack(v) for v in s]
        return tuple(vals) if isinstance(s, tuple) else vals

    packed = _pack(structure)
    if flat:
        raise ValueError(f"{len(flat)} leaves left over after packing")
    return packed


def map_structure(fn: Callable, *structures: Any) -> Any:
    flats = [flatten(s) for s in structures]
    n = len(flats[0])
    if any(len(f) != n for f in flats):
        raise ValueError("structures do not have matching leaf counts")
    results = [fn(*leaves) for leaves in zip(*flats)]
    return pack_sequence_as(structures[0], results)
