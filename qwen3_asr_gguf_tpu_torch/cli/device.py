"""The torch device of a command-line entry point: the card unless the
caller names another, and no fallback when the card is missing."""

from __future__ import annotations


def cli_device(name: str, what: str = "the CLI"):
    """torch.device(name); raises RuntimeError for a CUDA device on a
    machine without one."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device: {what} runs on --device {name} or not at all "
                           "(pass --device cpu to choose the CPU)")
    return device
