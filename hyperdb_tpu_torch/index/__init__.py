"""Candidate indexes: the exact flat scan, IVF and the reduced-rank
two-stage scan (projscan)."""

from hyperdb_tpu_torch.index.flat import FlatIndex

__all__ = ["FlatIndex", "index_from_state"]


def index_from_state(state: dict, device=None):
    """Restore a persisted index from its ``state()`` dict by ``kind``:
    the one dispatch point for the ``.ann`` sidecar and the checkpoint's
    ``index.npz``. ``device`` is where an index keeps its device state (the
    DB's device; the card unless the caller asks for the CPU)."""
    kind = state.get("kind")
    if kind == "ivf":
        from hyperdb_tpu_torch.index.ivf import IVFIndex

        return IVFIndex.from_state(state, device=device)
    if kind == "projscan":
        from hyperdb_tpu_torch.index.projscan import ProjScanIndex

        return ProjScanIndex.from_state(state, device=device)
    return FlatIndex.from_state(state)
