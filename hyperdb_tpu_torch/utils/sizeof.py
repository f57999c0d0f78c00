"""Recursive deep-size estimation.

Replaces the reference's ``pympler.asizeof`` dependency
(reference hyperdb.py:1405) for cache-memory introspection.
"""

from __future__ import annotations

import sys


def deep_sizeof(obj, _seen: set | None = None) -> int:
    """Best-effort recursive ``sys.getsizeof`` over containers."""
    if _seen is None:
        _seen = set()
    oid = id(obj)
    if oid in _seen:
        return 0
    _seen.add(oid)

    try:
        size = sys.getsizeof(obj)
    except TypeError:
        size = 0

    # numpy arrays: count the buffer (getsizeof already includes it for
    # owning arrays, but views report only the header). object-dtype arrays
    # hold POINTERS in their buffer — recurse into the elements instead of
    # reporting 8 bytes per entry.
    nbytes = getattr(obj, "nbytes", None)
    if nbytes is not None and isinstance(nbytes, int):
        dtype = getattr(obj, "dtype", None)
        if dtype is not None and getattr(dtype, "kind", "") == "O":
            try:
                return size + sum(
                    deep_sizeof(item, _seen) for item in obj.flat
                )
            except Exception:
                return size
        size = max(size, int(nbytes))
        return size

    if isinstance(obj, dict):
        size += sum(
            deep_sizeof(k, _seen) + deep_sizeof(v, _seen) for k, v in obj.items()
        )
    elif isinstance(obj, (list, tuple, set, frozenset)):
        size += sum(deep_sizeof(item, _seen) for item in obj)
    elif hasattr(obj, "items") and callable(obj.items) and not isinstance(obj, type):
        try:
            size += sum(
                deep_sizeof(k, _seen) + deep_sizeof(v, _seen) for k, v in obj.items()
            )
        except Exception:
            pass
    return size
