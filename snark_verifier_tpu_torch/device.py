"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None means the CUDA card.  A CUDA device comes back indexed: None and
    "cuda" mean `cuda:{torch.cuda.current_device()}`, so every per-device
    cache (constant memory, uploaded tables) sees one key per physical card.
    Raises when CUDA is asked for (or implied) and absent, or when the index
    names no card: the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "snark_verifier_tpu_torch: no CUDA device; pass device='cpu' to "
            "run the plain PyTorch path"
        )
    if dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"snark_verifier_tpu_torch: no CUDA device {dev.index} "
                           f"({torch.cuda.device_count()} present)")
    return dev


def device_key(device) -> str:
    """The cache key of `device`: "cpu", or the "cuda:i" that
    `resolve_device` makes of it."""
    dev = torch.device(device)
    return str(resolve_device(dev) if dev.type == "cuda" else dev)
