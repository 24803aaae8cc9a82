"""gdmcf_torch — the graph-diffusion recommender in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

Module names follow the JAX package one for one, so each counterpart is easy
to find; the port imports nothing of that package or of JAX.

Device policy: entry points run on ``cuda`` unless the caller asks for
``device="cpu"``. Without a CUDA device and without that request they raise;
they never quietly run on the CPU.

Importing the package loads no torch: the pre-forked HTTP fronts
(``serve_front``) import it and must stay light.
"""

from __future__ import annotations

__version__ = "0.1.0"


def resolve_device(device=None):
    """``None`` means ``cuda``. A CUDA request without a CUDA device raises.
    Returns a ``torch.device``."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: gdmcf_torch runs on the GPU by default; pass "
            "device='cpu' (or --device cpu) to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
