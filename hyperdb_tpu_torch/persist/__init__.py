"""Persistence: pickle(.gz)/JSON/SQLite parity formats, the binary
checkpoint directory, and the index sidecars."""

from hyperdb_tpu_torch.persist.io import (
    PAYLOAD_FIELDS,
    load_payload,
    save_payload,
)

__all__ = ["PAYLOAD_FIELDS", "load_payload", "save_payload"]
