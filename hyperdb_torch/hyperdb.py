"""Reference-shaped compat module over the PyTorch/CUDA port.

Counterpart of the JAX package's ``hyperdb/hyperdb.py``. Reference user code
imports from this module path (``from hyperdb_torch.hyperdb import
HyperDB``) and relies on its module-level surface, which
``from hyperdb_torch import *`` re-exports:

- ``HyperDB``: the port's engine with the reference's quirk (see below),
  on the card unless the caller passes ``device="cpu"``;
- ``MAX_LENGTH`` (510, the reference's 512 less two special tokens);
- ``NESTED_PATTERN`` (the reference's nested-key splitter);
- ``EMBEDDING_MODEL`` / ``tokenizer``: the reference's lazily set module
  globals; here the engine owns its encoder, so they stay None unless user
  code assigns them;
- ``ranking``: the ``hyperdb_torch.ranking_algorithm`` module alias.

Bug-for-bug quirk: the reference's precomputed-vectors constructor branch
never populates the metadata index, so metadata filters over such corpora
return nothing, and the reference's own test suite depends on exactly that.
This class reproduces the quirk; ``hyperdb_tpu_torch.HyperDB`` keeps the
fix. Pickles hold state, not the class, so either class loads the other's.
"""

from __future__ import annotations

import re

import hyperdb_torch.ranking_algorithm as ranking  # noqa: F401 — reference alias
from hyperdb_tpu_torch import HyperDB as _TorchHyperDB

EMBEDDING_MODEL = None
tokenizer = None
MAX_LENGTH = 510
NESTED_PATTERN = re.compile(r"[\[\].]")


class HyperDB(_TorchHyperDB):
    """Drop-in reference ``HyperDB`` (bug-for-bug constructor metadata quirk)."""

    _index_constructor_metadata = False


__all__ = [
    "HyperDB",
    "EMBEDDING_MODEL",
    "tokenizer",
    "MAX_LENGTH",
    "NESTED_PATTERN",
    "ranking",
]
