"""Device selection and the device-memory budget for the database.

Counterpart of metacache_tpu/utils/platform.py. ``get_device`` returns
the CUDA device when one is present; without one it raises unless
``MC_TORCH_DEVICE=cpu`` asks for the CPU (the counterpart of
``MC_JAX_PLATFORM``), so that no run silently falls back to the CPU.
"""
from __future__ import annotations

import os

import torch


def get_device() -> torch.device:
    if os.environ.get("MC_TORCH_DEVICE") == "cpu":
        return torch.device("cpu")
    if torch.cuda.is_available():
        return torch.device("cuda")
    raise RuntimeError(
        "no CUDA device is available; set MC_TORCH_DEVICE=cpu to run the "
        "plain PyTorch versions of the kernels on the CPU")


def hbm_budget_bytes(device: torch.device | None = None) -> int:
    """Device memory available for the database tables: the card's total
    memory minus a reserve of max(2 GiB, 20%) for batch working sets, the
    rule of metacache_tpu/utils/platform.py:81. MC_HBM_GB overrides the
    total (platform.py:55-61). On the CPU the total is taken as 16 GiB,
    so that layout choices in tests match the JAX package's CPU runs."""
    total = _total_bytes(device)
    reserve = max(2 << 30, total // 5)
    return max(total - reserve, 64 << 20)


def _total_bytes(device: torch.device | None) -> int:
    try:
        total = int(float(os.environ.get("MC_HBM_GB", "")) * 2**30)
    except ValueError:
        total = 0
    if total:
        return total
    if device is not None and device.type == "cuda":
        return torch.cuda.mem_get_info(device)[1]
    return 16 << 30


def free_bytes(device: torch.device) -> int:
    """Device memory a batch's working set can take now: on the card, the
    free memory plus what PyTorch's allocator holds unused; on the CPU,
    the reserve the budget above keeps for batch working sets (of 16 GiB,
    or MC_HBM_GB)."""
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return free + torch.cuda.memory_reserved(device) - \
            torch.cuda.memory_allocated(device)
    return _total_bytes(device) - hbm_budget_bytes(device)
