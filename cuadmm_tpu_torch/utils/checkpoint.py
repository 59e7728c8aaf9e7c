"""Checkpoint / resume helpers.

The reference supports warm starts only (X/y/S/sig into init,
re-entrant solve; reference: src/solver.cu:125-141, :385-409) with no
mid-run serialization. A checkpoint is the unscaled iterates + sigma;
resuming is a warm start. The file format (.npz, keys X, y, S, sig,
written by ``np.savez_compressed``) is the JAX package's
(cuadmm_tpu/utils/checkpoint.py), so a checkpoint written by either
package loads in the other.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A numpy copy of ``x``; a tensor (on any device) is copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path: str, result_or_state, sig: Optional[float] = None) -> None:
    """Save unscaled (X, y, S, sig) from an SDPResult (or any object with
    .X/.y/.S and .sig; tensors are copied to the host)."""
    X = _host(result_or_state.X)
    y = _host(result_or_state.y)
    S = _host(result_or_state.S)
    s = float(sig if sig is not None else getattr(result_or_state, "sig", 1.0))
    np.savez_compressed(path, X=X, y=y, S=S, sig=s)


def load_checkpoint(path: str):
    """Returns dict(X0=..., y0=..., S0=..., sig=...) ready to splat into
    SDPSolver.solve(**ckpt)."""
    with np.load(path) as z:
        return dict(X0=z["X"], y0=z["y"], S0=z["S"], sig=float(z["sig"]))
