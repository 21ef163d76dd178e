"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda:0`` unless the caller names a device.  A CUDA device that
    is not there raises; the CPU is used only when asked for."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{dev} requested but no CUDA device is available "
                "(pass device='cpu' to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def current_stream(index: int) -> int:
    """The raw handle of device ``index``'s current stream, from torch's
    own accessor, which Triton's launcher calls too: building a
    ``torch.cuda.Stream`` object each call was one of the largest parts
    of a decode call's host time."""
    return torch._C._cuda_getCurrentRawStream(index)
