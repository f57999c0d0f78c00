"""Nested document-path resolution and key selection.

Pure host-side functions over Python document trees, matching the reference
semantics for:

- ``get_nested_value`` (reference hyperdb.py:1035-1058): path
  lookup with dotted keys, ``[i]`` list indexing, and mapping a key over a
  list of dicts.
- ``filter_document`` / select_keys (hyperdb.py:394-408): stored filtered
  documents use the *flattened* key string as a literal dict key
  (SURVEY.md Q14) and fall back to the full document when nothing matched.
- ``collect_document_keys`` (hyperdb.py:344-371): recursive flattened-key
  census including ``key[i]`` index keys for list items.
- ``validate_keys`` (hyperdb.py:339-342).
"""

from __future__ import annotations

import re
from typing import Any, Iterable, Sequence

# Splits a flattened path on '.', '[' and ']' (reference NESTED_PATTERN,
# hyperdb.py:27).
NESTED_PATTERN = re.compile(r"[\[\].]")


def split_path(key: str) -> list[str]:
    """'moves[0].name' -> ['moves', '0', 'name']."""
    return [part for part in NESTED_PATTERN.split(key) if part]


def get_nested_value(dictionary: Any, keys: Sequence[str] | str) -> Any:
    """Follow a sequence of (possibly compound) keys through a document.

    Each element of ``keys`` may itself be a compound path ('moves[0].name');
    digits index lists, names index dicts, and a name applied to a list of
    dicts maps over the list. Missing paths yield None.
    """
    if isinstance(keys, str):
        keys = [keys]
    try:
        value = dictionary
        for key in keys:
            for part in split_path(key):
                if value is None:
                    break
                if part.isdigit():
                    index = int(part)
                    value = (
                        value[index]
                        if isinstance(value, list) and index < len(value)
                        else None
                    )
                elif isinstance(value, dict):
                    value = value.get(part, None)
                elif isinstance(value, list):
                    value = [
                        sub.get(part, None) for sub in value if isinstance(sub, dict)
                    ]
                else:
                    value = None
        return value
    except (KeyError, TypeError, AttributeError, IndexError):
        return None


def filter_document(document: Any, select_keys: Sequence[str] | None) -> Any:
    """Project a document onto ``select_keys`` using flattened key names.

    Returns the original document unchanged when there are no select_keys,
    the document is not a dict, or no key resolved (reference fallback,
    hyperdb.py:408).
    """
    if not select_keys or not isinstance(document, dict):
        return document
    filtered: dict[str, Any] = {}
    for full_key in select_keys:
        value = get_nested_value(document, [full_key])
        if value is not None:
            filtered[full_key] = value
    return filtered if filtered else document


def collect_document_keys(documents: Iterable[Any]) -> list[str]:
    """Census of all flattened keys across documents (incl. list indices)."""
    keys: set[str] = set()

    def walk(node: Any, prefix: str) -> None:
        if isinstance(node, dict):
            for key, value in node.items():
                full = f"{prefix}.{key}" if prefix else key
                keys.add(full)
                if isinstance(value, (dict, list)):
                    walk(value, full)
        elif isinstance(node, list):
            for i, item in enumerate(node):
                full = f"{prefix}[{i}]"
                keys.add(full)
                if isinstance(item, (dict, list)):
                    walk(item, full)

    for document in documents:
        walk(document, "")
    return list(keys)


def validate_keys(
    keys_to_validate: Iterable[str],
    keys_validation: Iterable[str],
    keys_to_validate_name: str,
    keys_validation_name: str,
) -> None:
    valid = set(keys_validation)
    for key in keys_to_validate:
        if key not in valid:
            raise ValueError(
                f"Invalid key '{key}' in {keys_to_validate_name} "
                f"not found in {keys_validation_name}."
            )
