"""Kernel-or-plain dispatch and the kernels' launch counters.

The rule is the tensor's device and nothing else: a tensor on the CPU takes
the kernel's plain PyTorch version, a CUDA tensor takes the hand-written
kernel, any other device raises. There is no environment override and no
fallback: a CUDA call whose kernel does not build or launch raises.

``launches`` counts kernel launches per kernel. Each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its path
went through the kernels (see ``chip_smoke.py``). ``rdb_int8_int32_taps``
counts the int8 RDB blocks that ran the per-channel ``int32_taps`` scheme
(each also counts under ``rdb_int8``).
"""

from __future__ import annotations

import torch

KERNELS = ("d2s_packed", "correlation", "conv_chain", "conv_chain_dw3", "rdb",
           "conv_chain_int8", "rdb_int8", "planar_chain", "rdb_int8_int32_taps",
           "rdb_taps", "d2s_packed_planar", "probe")
launches = dict.fromkeys(KERNELS, 0)


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raise otherwise."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain version for device {dev}")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
