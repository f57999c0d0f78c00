"""Logging shims.

The reference signals soft failures and fallbacks with bare ``print`` calls
(SURVEY.md Q20), and its tests assert on captured stdout (e.g. the
"Bruteforce method used instead" message). We keep user-facing INFO/WARNING
messages on stdout for that parity, while also mirroring them into a standard
``logging`` logger (`hyperdb_tpu_torch`) for structured consumers.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("hyperdb_tpu_torch")


def info(msg: str) -> None:
    print(msg)
    logger.info(msg)


def warn(msg: str) -> None:
    print(msg)
    logger.warning(msg)
