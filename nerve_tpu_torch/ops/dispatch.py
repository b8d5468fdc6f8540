"""Kernel-or-plain dispatch and the kernels' launch counters.

The rule is the tensor's device and nothing else: a tensor on the CPU takes
the kernel's plain PyTorch version, a CUDA tensor takes the hand-written
kernel, any other device raises. There is no environment override and no
fallback: a CUDA call whose kernel does not build or launch raises.

``launches`` counts kernel launches per kernel. Each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its path
went through the kernels (see ``chip_smoke.py``). ``rdb_int8_int32_taps``
counts the int8 RDB blocks that ran the per-channel ``int32_taps`` scheme
(each also counts under ``rdb_int8``). ``rdb_lff`` and ``rdb_lff_i8`` count
the RDB fusions' launches (one per block, beside ``rdb`` or ``rdb_int8``;
``rdb_taps`` blocks also run ``rdb_lff``).

``packs`` counts the int8 states (a chain, an RDB stack) packed into the
int8 layer kernel's weight image: host work, no launch. A model packs each
of its int8 states once and keeps the packs, so a served frame packs none.
"""

from __future__ import annotations

import torch

KERNELS = ("d2s_packed", "correlation", "conv_chain", "conv_chain_dw3", "rdb",
           "conv_chain_int8", "rdb_int8", "planar_chain", "rdb_int8_int32_taps",
           "rdb_taps", "d2s_packed_planar", "probe", "quantize_i8", "rdb_lff", "rdb_lff_i8")
launches = dict.fromkeys(KERNELS, 0)
packs = {"int8": 0}


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raise otherwise.

    Every kernel launch passes here, so a single tensor takes the tensor's
    own flags (no ``torch.device`` object is made)."""
    t0 = tensors[0]
    if len(tensors) > 1:
        dev = t0.device
        for t in tensors[1:]:
            if t.device != dev:
                raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if t0.is_cuda:
        return True
    if t0.is_cpu:
        return False
    raise ValueError(f"no kernel and no plain version for device {t0.device}")


def reset_launches() -> None:
    """Set every launch count and the pack count to 0."""
    for k in launches:
        launches[k] = 0
    packs["int8"] = 0
