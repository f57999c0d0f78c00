"""Host-side utilities: LRU cache, deep sizeof, logging, timers."""

from hyperdb_tpu_torch.utils.lru import LRUCache
from hyperdb_tpu_torch.utils.sizeof import deep_sizeof
from hyperdb_tpu_torch.utils.log import info, warn

__all__ = ["LRUCache", "deep_sizeof", "info", "warn"]
