"""Command-line entry points of the port (ports of ``repro.launch.train``
and ``repro.launch.serve``):

    python -m repro_torch.launch.train --arch mixtral-8x7b --reduced ...
    python -m repro_torch.launch.serve --arch mixtral-8x7b --policy lfu ...

Each takes ``--device`` (default ``cuda``) and refuses to start on a
CUDA device when there is none (``require_device``)."""
import torch


def require_device(device: str) -> torch.device:
    """``device`` as a ``torch.device``; exits non-zero when it names a
    CUDA device and PyTorch sees none (there is no fallback to the CPU:
    pass ``--device cpu`` for a CPU run)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"device {device!r}: torch.cuda.is_available() is "
                         f"False; pass --device cpu to run on the CPU")
    return dev
