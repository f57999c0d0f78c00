"""Device->host transfer helper."""

from __future__ import annotations

import numpy as np
import torch


def fetch(*arrays):
    """Read back any number of tensors (or host arrays) as NumPy arrays,
    in argument order."""
    return tuple(
        a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        for a in arrays
    )
