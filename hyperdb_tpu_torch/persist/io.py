"""Checkpoint formats.

Counterpart of ``hyperdb_tpu/persist/io.py``, file-compatible with it in
both directions. Round-trips the reference's six-field payload
(hyperdb.py:774-781):

    vectors, documents, source_indices, split_info, metadata_index,
    vectors_normalized

in three interchangeable on-disk formats, file-compatible with the
reference:

- pickle, with transparent gzip when the filename ends in ``.gz`` and
  gzip-then-plain autodetect on load (hyperdb.py:803-812, 946-953),
- JSON (vectors as nested lists, hyperdb.py:814-819),
- SQLite with the reference's six-table schema (hyperdb.py:821-898).

Two conscious fixes over the reference:
- pickle stores vectors as a binary NumPy ndarray (the host master, never
  a torch tensor, so files cross between the packages) instead of Python lists
  (the reference round-trips a potentially 1M x 384 matrix through
  ``tolist()``, hyperdb.py:775 — SURVEY.md §5 checkpoint note),
- JSON/SQLite loads restore integer keys for ``split_info`` and
  ``metadata_index`` (JSON stringifies dict keys; the reference leaves them
  as strings, silently breaking chunk bookkeeping after a JSON round trip).
"""

from __future__ import annotations

import gzip
import json
import pickle
import sqlite3
from contextlib import closing

import numpy as np

PAYLOAD_FIELDS = (
    "vectors",
    "documents",
    "source_indices",
    "split_info",
    "metadata_index",
    "vectors_normalized",
)

FORMATS = ("pickle", "json", "sqlite")


def _intkeys(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        try:
            out[int(k)] = v
        except (TypeError, ValueError):
            out[k] = v
    return out


# --------------------------------------------------------------- pickle


def _save_pickle(path: str, data: dict) -> None:
    try:
        payload = dict(data)
        payload["vectors"] = np.asarray(data["vectors"])
        if str(path).endswith(".gz"):
            with gzip.open(path, "wb") as f:
                pickle.dump(payload, f)
        else:
            with open(path, "wb") as f:
                pickle.dump(payload, f)
    except Exception as e:
        raise RuntimeError(f"An exception occurred during pickle save: {e}")


def _load_pickle(path: str) -> dict:
    try:
        with gzip.open(path, "rb") as f:
            return pickle.load(f)
    except OSError:
        with open(path, "rb") as f:
            return pickle.load(f)


# --------------------------------------------------------------- json


def _save_json(path: str, data: dict) -> None:
    try:
        payload = dict(data)
        payload["vectors"] = [
            v.tolist() if hasattr(v, "tolist") else list(v) for v in data["vectors"]
        ]
        with open(path, "w") as f:
            json.dump(payload, f)
    except Exception as e:
        raise RuntimeError(f"An exception occurred during JSON save: {e}")


def _load_json(path: str) -> dict:
    with open(path, "r") as f:
        return json.load(f)


# --------------------------------------------------------------- sqlite


_SQLITE_SCHEMA = (
    "CREATE TABLE IF NOT EXISTS documents (id INTEGER PRIMARY KEY, data TEXT)",
    "CREATE TABLE IF NOT EXISTS vectors (id INTEGER PRIMARY KEY, "
    "document_id INTEGER, vector BLOB)",
    "CREATE TABLE IF NOT EXISTS source_indices (id INTEGER PRIMARY KEY, "
    "value INTEGER)",
    "CREATE TABLE IF NOT EXISTS split_info (id INTEGER PRIMARY KEY, value TEXT)",
    "CREATE TABLE IF NOT EXISTS metadata_index (key TEXT PRIMARY KEY, value TEXT)",
    "CREATE TABLE IF NOT EXISTS settings (name TEXT PRIMARY KEY, value TEXT)",
)


def _save_sqlite(path: str, data: dict) -> None:
    with closing(sqlite3.connect(path)) as conn:
        cursor = conn.cursor()
        try:
            for stmt in _SQLITE_SCHEMA:
                cursor.execute(stmt)
            cursor.executemany(
                "INSERT INTO documents (data) VALUES (?)",
                [(json.dumps(doc),) for doc in data["documents"]],
            )
            vectors = np.asarray(data["vectors"])
            # document_id records the true source document index of each
            # chunk row (the reference writes the row number, hyperdb.py:846
            # — wrong for chunked corpora despite the column name).
            src = list(data.get("source_indices") or range(len(vectors)))
            cursor.executemany(
                "INSERT INTO vectors (document_id, vector) VALUES (?, ?)",
                [
                    (int(src[i]), json.dumps(np.asarray(v).tolist()))
                    for i, v in enumerate(vectors)
                ],
            )
            cursor.executemany(
                "INSERT INTO source_indices (value) VALUES (?)",
                [(int(i),) for i in data["source_indices"]],
            )
            cursor.execute(
                "INSERT INTO split_info (value) VALUES (?)",
                (json.dumps(data["split_info"]),),
            )
            cursor.executemany(
                "INSERT INTO metadata_index (key, value) VALUES (?, ?)",
                [(str(k), json.dumps(v)) for k, v in data["metadata_index"].items()],
            )
            cursor.execute(
                "INSERT OR REPLACE INTO settings (name, value) VALUES (?, ?)",
                ("vectors_normalized", json.dumps(bool(data["vectors_normalized"]))),
            )
            conn.commit()
        except sqlite3.Error as e:
            conn.rollback()
            raise RuntimeError(f"SQLite error during save: {e}")


def _load_sqlite(path: str) -> dict:
    with closing(sqlite3.connect(path)) as conn:
        cursor = conn.cursor()
        try:
            # Explicit ORDER BY id everywhere: implicit rowid order is not a
            # documented SQLite guarantee (e.g. after VACUUM on a table with
            # deletes), and row order IS the chunk-row order invariant.
            documents = [
                json.loads(row[0])
                for row in cursor.execute("SELECT data FROM documents ORDER BY id")
            ]
            vectors = [
                json.loads(row[0])
                for row in cursor.execute("SELECT vector FROM vectors ORDER BY id")
            ]
            source_indices = [
                row[0]
                for row in cursor.execute(
                    "SELECT value FROM source_indices ORDER BY id"
                )
            ]
            split_info = {}
            for row in cursor.execute("SELECT value FROM split_info"):
                split_info = json.loads(row[0])
            metadata_index = {
                row[0]: json.loads(row[1])
                for row in cursor.execute("SELECT key, value FROM metadata_index")
            }
            vectors_normalized = False
            for row in cursor.execute(
                "SELECT value FROM settings WHERE name = ?", ("vectors_normalized",)
            ):
                vectors_normalized = json.loads(row[0])
            return {
                "vectors": vectors,
                "documents": documents,
                "source_indices": source_indices,
                "split_info": split_info,
                "metadata_index": metadata_index,
                "vectors_normalized": vectors_normalized,
            }
        except sqlite3.Error as e:
            raise RuntimeError(f"SQLite error during load: {e}")


# --------------------------------------------------------------- facade


def save_payload(path: str, data: dict, format: str = "pickle") -> None:
    if format == "pickle":
        _save_pickle(path, data)
    elif format == "json":
        _save_json(path, data)
    elif format == "sqlite":
        _save_sqlite(path, data)
    else:
        raise ValueError(f"Unsupported format '{format}'")


def load_payload(path: str, format: str = "pickle") -> dict:
    if format == "pickle":
        data = _load_pickle(path)
    elif format == "json":
        data = _load_json(path)
    elif format == "sqlite":
        data = _load_sqlite(path)
    else:
        raise ValueError(f"Unsupported format '{format}'")
    data["split_info"] = _intkeys(data.get("split_info", {}) or {})
    data["metadata_index"] = _intkeys(data.get("metadata_index", {}) or {})
    data.setdefault("source_indices", [])
    data["source_indices"] = [int(i) for i in data["source_indices"]]
    data.setdefault("vectors_normalized", False)
    return data
