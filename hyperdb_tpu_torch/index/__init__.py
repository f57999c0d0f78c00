"""Candidate indexes: the exact flat scan. The IVF and projscan indexes of
the JAX package are not ported yet (ROADMAP.md queue 1, item 10)."""

from hyperdb_tpu_torch.index.flat import FlatIndex

__all__ = ["FlatIndex", "index_from_state"]


def index_from_state(state: dict):
    """Restore a persisted index from its ``state()`` dict by ``kind``:
    the one dispatch point for the ``.ann`` sidecar and the checkpoint's
    ``index.npz``. An IVF or projscan state raises: it is never replaced
    by a flat index behind the caller's back."""
    kind = state.get("kind")
    if kind in ("ivf", "projscan"):
        raise NotImplementedError(
            f"the {kind} index is not ported yet: ROADMAP.md queue 1, item 10"
        )
    return FlatIndex.from_state(state)
