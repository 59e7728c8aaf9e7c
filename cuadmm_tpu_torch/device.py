"""Device resolution and the f32 arithmetic policy.

The port never picks a device behind the caller's back: a CUDA device that
was asked for and is absent raises, it does not drop to the CPU.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device) -> torch.device:
    """Return ``device`` as a ``torch.device`` and set full-f32 arithmetic.

    Raises when a CUDA device is requested and CUDA is not available. On
    CUDA it turns TF32 off for matmuls and cuDNN: TF32 keeps ~3 decimal
    digits, which would corrupt the f32 Cholesky factor of a cond~1e7
    regularized AA^T. This is the counterpart of the JAX package's
    ``Precision.HIGHEST`` (cuadmm_tpu/solver/driver.py:542,
    cuadmm_tpu/ops/chol.py:517-529). ``SDPSolver.__init__`` calls it.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() is False"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r} (cuda or cpu)")
    return dev


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` prints them:
    the label every time measured on it carries."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def synchronize(device: torch.device) -> None:
    """Wait for ``device`` (a no-op on the CPU), so host clocks time device work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
