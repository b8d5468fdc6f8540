"""Federated wire format: parameters ⇄ an ordered list of numpy arrays.

Counterpart of ``nerve_tpu/federated/common.py``. Parameters are a mapping
of tensors (or numpy arrays) by dotted name, as ``named_parameters`` gives
them, or nested mappings of them. The list is in the order of the flax
tree's leaves (``jax.tree_util.tree_leaves``): paths compared part by part,
the keys of each level sorted as strings, so ``body0.BatchNorm_0.bias``
comes before ``body0.BatchNorm_0.scale``, ``body0.depthwise.kernel`` and
``head.bias``. Each array keeps its tensor's shape (the port stores kernels
in flax's HWIO layout) and dtype. A port client and a JAX-package server
therefore exchange the same arrays. BatchNorm statistics are buffers, not
parameters, and never cross the wire (FedBN: they stay with the client).
"""

from __future__ import annotations

from typing import Any, List, Mapping, Sequence, Tuple

import numpy as np
import torch

Params = Any


def _paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, Mapping):
        out = []
        for k, v in tree.items():
            out += _paths(v, prefix + tuple(str(k).split(".")))
        return out
    return [(prefix, tree)]


def ordered_leaves(tree: Params) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in the flax tree's leaf order."""
    return sorted(_paths(tree), key=lambda kv: kv[0])


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _like(array, leaf):
    """``array`` with ``leaf``'s shape, dtype and (for a tensor) device."""
    if isinstance(leaf, torch.Tensor):
        return torch.as_tensor(np.array(array), dtype=leaf.dtype,
                               device=leaf.device).reshape(leaf.shape)
    return np.asarray(array, dtype=np.asarray(leaf).dtype).reshape(np.shape(leaf))


def tree_to_arrays(tree: Params) -> List[np.ndarray]:
    """The leaves as numpy copies, in the flax tree's leaf order."""
    return [_numpy(leaf) for _, leaf in ordered_leaves(tree)]


def _rebuild(tree, new, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, Mapping):
        return {k: _rebuild(v, new, prefix + tuple(str(k).split("."))) for k, v in tree.items()}
    return new[prefix]


def tree_from_arrays(template: Params, arrays: Sequence[np.ndarray]) -> Params:
    """``template``'s structure holding ``arrays`` (in the order of
    ``tree_to_arrays``), each cast to its leaf's dtype and shape and, for a
    tensor, put on its device."""
    pairs = ordered_leaves(template)
    if len(arrays) != len(pairs):
        raise ValueError(f"expected {len(pairs)} arrays, got {len(arrays)}")
    return _rebuild(template, {path: _like(a, leaf) for (path, leaf), a in zip(pairs, arrays)})


# Reference-named aliases (nerve_cl/federated/client.py:15-24).
def get_parameters(params: Params) -> List[np.ndarray]:
    return tree_to_arrays(params)


def set_parameters(template: Params, arrays: Sequence[np.ndarray]) -> Params:
    return tree_from_arrays(template, arrays)
