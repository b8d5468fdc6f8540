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
``rdb_taps`` blocks also run ``rdb_lff``). ``conv_f32`` counts the float32
dense-layer kernel's launches (every float32 dense layer: a chain's, each
also under ``conv_chain``, and an RDB's, whose block counts under
``rdb``), ``rdb_lff_f32`` the float32 fusion's (each also under
``rdb_lff``).

``packs`` counts the int8 states (a chain, an RDB stack) packed into the
int8 layer kernel's weight image: host work, no launch. A model packs each
of its int8 states once and keeps the packs, so a served frame packs none.

Under autograd (``needs_grad``) a kernel op runs as a
``torch.autograd.Function``: its forward is the dispatch above, its
backward ``recompute_vjp``, the vjp of the op's plain version recomputed
from the saved inputs, as the JAX package's ``custom_vjp`` backward is the
vjp of its XLA formulation; under ``create_graph=True`` the recompute keeps
its graph, so gradients of gradients (second-order MAML) are the plain
version's. No kernel has a backward of its own, since no Pallas kernel had
one; the recompute runs inside a profiler range named ``RECOMPUTE_RANGE``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

RECOMPUTE_RANGE = "nt.recompute"
KERNELS = ("d2s_packed", "correlation", "conv_chain", "conv_chain_dw3", "rdb",
           "conv_chain_int8", "rdb_int8", "planar_chain", "rdb_int8_int32_taps",
           "rdb_taps", "d2s_packed_planar", "probe", "quantize_i8", "rdb_lff", "rdb_lff_i8",
           "conv_f32", "rdb_lff_f32")
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


def needs_grad(*tensors: torch.Tensor) -> bool:
    """True where autograd records this call: grad mode is on (never under
    ``torch.no_grad`` or ``torch.inference_mode``) and a tensor requires its
    gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def recompute_vjp(plain: Callable, inputs: Sequence[torch.Tensor], needs: Sequence[bool],
                  grad_out: torch.Tensor) -> List[Optional[torch.Tensor]]:
    """The vjp of ``plain(*inputs)`` at ``grad_out``: ``plain`` recomputed
    under autograd, one gradient per input (None where ``needs`` is False).

    A first-order backward runs with grad mode off: the recompute starts
    from detached copies of ``inputs`` and the gradients have no graph.
    Under ``create_graph=True`` autograd runs the backward with grad mode
    on: then the recompute starts from the saved inputs themselves (each
    through an alias of its own, so that a tensor passed twice gets one
    gradient per position) and keeps its graph, so the double backward is
    the plain version's, as JAX differentiates a ``custom_vjp`` backward
    (the vjp of the XLA formulation)."""
    create_graph = torch.is_grad_enabled()
    with torch.enable_grad():
        if create_graph:
            leaves = [t.view_as(t) if n else t for t, n in zip(inputs, needs)]
        else:
            leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        with torch.profiler.record_function(RECOMPUTE_RANGE):
            out = plain(*leaves)
        wanted = [t for t, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(out, wanted, grad_out, allow_unused=True,
                                         create_graph=create_graph))
    return [next(grads) if n else None for n in needs]
