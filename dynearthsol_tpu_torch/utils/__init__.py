"""Host-side helpers (counterpart of dynearthsol_tpu/utils/).

``geotherm``, ``gravity`` and ``terrigenous`` take tensors or arrays and
return float64 tensors on ``device``: by default the device of the first
tensor argument, else the card, as ``Simulation`` defaults to it (without
one they raise; the CPU is asked for with ``device="cpu"``).
"""

from __future__ import annotations

import torch


def resolve_device(device, *xs) -> torch.device:
    """``device`` if given, else that of the first tensor among ``xs``,
    else the card (RuntimeError without one)."""
    if device is not None:
        return torch.device(device)
    for x in xs:
        if torch.is_tensor(x):
            return x.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the analytic helpers run on the CUDA device by default and "
            "none is available; pass device='cpu'")
    return torch.device("cuda")


def f64(x, device) -> torch.Tensor:
    """``x`` (a tensor, an array, a list or a number) as a float64 tensor
    on ``device``."""
    return torch.as_tensor(x, dtype=torch.float64, device=device)
