"""State carried between the JAX package's arrays and the port's tensors.

The JAX package holds limbs and counts as uint32 arrays; the port holds
the same layout as int32 tensors (every limb is below 2^16).  These two
functions carry any named set of them -- the herd (px, py, d), the
symmetry walk's classes (symclass), the jump tables (jx, jy, jd), the DP
masks, the DP slot outputs (count, dpx, dpd, step) -- across, so both
packages compute on identical inputs.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def from_numpy_state(arrays: Mapping[str, np.ndarray],
                     device) -> Dict[str, torch.Tensor]:
    """uint32 (or any integer) numpy arrays -> int32 tensors on device.

    Raises ValueError for values that do not fit int32's non-negative
    range (no limb, mask or count of the walk can).
    """
    out = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        if a.size and (a.min() < 0 or a.max() >= 1 << 31):
            raise ValueError(f"{name}: values outside [0, 2^31)")
        out[name] = torch.from_numpy(
            np.ascontiguousarray(a.astype(np.int32))
        ).to(device)
    return out


def to_numpy_state(tensors: Mapping[str, torch.Tensor]
                   ) -> Dict[str, np.ndarray]:
    """int32 tensors (any device) -> uint32 numpy arrays."""
    out = {}
    for name, t in tensors.items():
        a = t.detach().cpu().numpy()
        if a.size and a.min() < 0:
            raise ValueError(f"{name}: negative values")
        out[name] = a.astype(np.uint32)
    return out
