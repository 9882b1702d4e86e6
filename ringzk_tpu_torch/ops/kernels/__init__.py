"""Hand-written CUDA kernels (``csrc/``) and their plain PyTorch versions.

The counterpart of ``ringzk_tpu/ops/pallas``. Each module holds, for one
kernel, a wrapper and the plain version of the same function. The wrapper
takes the plain version only for tensors on the CPU; for a CUDA tensor it
launches the kernel or raises. ``LAUNCHES`` counts kernel launches by
name, so a run can show that its main path went through each kernel.
"""

from __future__ import annotations

import torch

LAUNCHES = {"ntt_fwd": 0, "ntt_inv": 0, "matvec_digits": 0, "challenge_select": 0,
            "scalar_mul_add": 0, "matvec_colblock": 0, "ntt_fwd_wide": 0, "ntt_inv_wide": 0,
            "ntt_fwd_one": 0, "ntt_inv_one": 0, "ntt_dense": 0, "mac_chain": 0,
            "modq_add": 0, "modq_sub": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def device_cache(ring, key, make):
    """Per-ring cache of device constants (twiddles, fold constants):
    ``make()`` runs once per key, which names the device."""
    cache = ring.__dict__.setdefault("_device_cache", {})
    if key not in cache:
        cache[key] = make()
    return cache[key]


def on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True when the arguments lie on one CUDA device (launch the kernel),
    False when they all lie on the CPU (use the plain version); raise for
    anything else."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"{name}: tensors on {sorted({str(t.device) for t in tensors})}; "
                     "need all on the CPU or all on one CUDA device")


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless t has the dtype, shape and contiguity a kernel takes."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: need contiguous {dtype} {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor's data starts on a 16-byte boundary: the
    kernels read and write their rows as 16-byte vectors, and a misaligned
    one would fault on the card (a fault that ends the CUDA context)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: a {t.dtype} {tuple(t.shape)} argument starts "
                             f"{t.data_ptr() % 16} bytes past a 16-byte boundary "
                             f"(storage offset {t.storage_offset()}); pass a fresh copy")


def launch(name: str, fn: str, device: torch.device, *args) -> None:
    """Call C entry point ``fn`` on ``device``'s current stream; raise on a
    launch error or a misaligned tensor, count the launch otherwise. Tensor
    arguments pass as pointers, ints as ints."""
    from ._lib import lib

    check_aligned(name, *(a for a in args if isinstance(a, torch.Tensor) and a.is_cuda))
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = getattr(lib(), fn)(*ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc}")
    LAUNCHES[name] += 1
