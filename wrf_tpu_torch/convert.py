"""Carry the prepared state between the two packages.

This system has no weights: its "parameters" are the prepared ring-shaped
field dict (``wrf_tpu_torch.parallel.sharded.case_to_domain``, numpy, as the
JAX ``SmallStepLoop.prepare`` receives it).  Tests feed both packages from
one such dict.
"""

from __future__ import annotations

import numpy as np
import torch


def arrays_from_numpy(dom: dict, device) -> dict[str, torch.Tensor]:
    """float32 tensors on ``device``, one per field.  Every tensor is a
    copy: the port updates some state in place, and must never write
    through to the caller's numpy arrays."""
    device = torch.device(device)
    return {name: torch.tensor(np.asarray(arr, dtype=np.float32), device=device)
            for name, arr in dom.items()}


def arrays_to_numpy(arrays: dict) -> dict[str, np.ndarray]:
    """Host float32 numpy copies of a dict of tensors."""
    return {name: t.detach().to("cpu", torch.float32).numpy()
            for name, t in arrays.items()}
