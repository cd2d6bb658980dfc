"""Where the package's entry points run.

Every entry point takes ``device=None`` and runs on the CUDA card: the
kernels exist only there. A caller that wants the CPU (the tests, which run
the kernels' plain versions) says ``device="cpu"``. There is no silent
fallback: without a card ``None`` raises.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` -> the CUDA device, or ``RuntimeError`` where there is none;
    anything else -> ``torch.device(device)``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this package runs on the GPU by default; pass "
            'device="cpu" to run the plain PyTorch versions on the CPU'
        )
    return torch.device("cuda")
