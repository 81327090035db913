"""Device resolution shared by every entry point of the port.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Asking for ``cuda`` on a machine without a card raises: the port never
carries on quietly on the CPU.
"""
from __future__ import annotations

import weakref

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def torch_dtype(name) -> torch.dtype:
    """Config dtype string ('bfloat16', 'float32', ...) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[str(name)]


def _unregister(ptr: int):
    torch.cuda.cudart().cudaHostUnregister(ptr)


def pinned_empty(shape, dtype) -> torch.Tensor:
    """An uninitialised CPU tensor whose pages are locked for DMA
    (``cudaHostRegister`` over exactly its bytes; PyTorch's pinned allocator
    would round a large request up to a power of two).  Raises if the pages
    cannot be locked: the caller never gets pageable memory in their place.
    The pages are unlocked when the tensor is freed."""
    t = torch.empty(shape, dtype=dtype)
    nbytes = t.numel() * t.element_size()
    if nbytes == 0:
        return t
    if not torch.cuda.is_available():
        raise RuntimeError("pinned host memory needs a CUDA card")
    err = torch.cuda.cudart().cudaHostRegister(t.data_ptr(), nbytes, 0)
    if int(err) != 0:
        raise RuntimeError(
            f"cudaHostRegister of {nbytes / 1e9:.2f} GB failed with "
            f"cudaError_t {int(err)}; the host store needs page-locked "
            "memory (check MemAvailable and the locked-memory limit)")
    weakref.finalize(t, _unregister, t.data_ptr())
    return t
