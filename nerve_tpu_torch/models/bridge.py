"""Load the JAX package's flax variables into the port's modules.

The port's modules carry the flax tree's names, so a flax path
``params/feature_extractor/head/kernel`` is ``state_dict()`` key
``feature_extractor.head.kernel`` and a ``batch_stats`` path is the
BatchNorm buffer of the same name. The ``"quant"`` collection of an int8
model holds tuples and lists; their indices name the port's buffers
(``quant/rdbs/qchain[b][0][i]``, block b's dense weights i, is
``rdbs.qchain.{b}.0.{i}``; see ``layers.QuantState``). Layouts are the same
too (HWIO kernels, the RDB fusion as a 2-D matrix, the int8 wire format),
so loading is a copy. It is strict: a missing, unused or misshapen entry
raises, and int8 entries stay int8 and may fill only int8 buffers. A model
quantised with ``PER_CHANNEL_INT8`` loads unchanged: its wire format is the
same (the per-channel factors tiled over the taps), and serving it takes
``ops.rdb_int8.PER_CHANNEL_INT8 = True`` in the port too.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn as nn

from nerve_tpu_torch.models.super_resolution import LightweightSuperResolution, SuperResolutionNet

COLLECTIONS = ("params", "batch_stats", "quant")


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Leaves of nested mappings, tuples and lists under dotted keys (a
    sequence's items by index)."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, Sequence) and not isinstance(tree, str):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}."))
    return out


def load_flax_variables(module: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Copy a flax ``{"params", "batch_stats", "quant"}`` tree (numpy
    leaves) into ``module``'s parameters and buffers, strictly."""
    unknown = sorted(set(variables) - set(COLLECTIONS))
    if unknown:
        raise KeyError(f"unknown flax collections {unknown}")
    flat: Dict[str, np.ndarray] = {}
    for coll in COLLECTIONS:
        for k, v in _flatten(variables.get(coll, {})).items():
            if k in flat:
                raise KeyError(f"{k!r} appears in more than one collection")
            flat[k] = v
    state = module.state_dict()
    missing = sorted(set(state) - set(flat))
    unused = sorted(set(flat) - set(state))
    if missing or unused:
        raise KeyError(f"flax variables do not match the module: missing {missing}, "
                       f"unused {unused}")
    new = {}
    for k, t in state.items():
        arr = flat[k]
        if arr.shape != tuple(t.shape):
            raise ValueError(f"{k}: flax shape {arr.shape}, module shape {tuple(t.shape)}")
        if (arr.dtype == np.int8) != (t.dtype == torch.int8):
            raise TypeError(f"{k}: flax {arr.dtype} for a module {t.dtype} tensor")
        if arr.dtype != np.int8:
            arr = np.asarray(arr, dtype=np.float32)
        new[k] = torch.from_numpy(arr)
    module.load_state_dict(new, strict=True)
    return module


def sr_from_flax(variables_numpy: Mapping[str, Any], device="cuda",
                 **config) -> SuperResolutionNet:
    """A ``SuperResolutionNet(**config)`` in eval mode holding the flax
    variables (with ``quantized``/``quantized_chains``, their ``"quant"``
    collection too), on the card unless ``device="cpu"``."""
    model = SuperResolutionNet(device=device, **config)
    return load_flax_variables(model, variables_numpy).eval()


def lightweight_from_flax(variables_numpy: Mapping[str, Any], device="cuda",
                          **config) -> LightweightSuperResolution:
    """A ``LightweightSuperResolution(**config)`` in eval mode holding the
    flax variables (``params`` and ``batch_stats``), strictly, on the card
    unless ``device="cpu"``."""
    model = LightweightSuperResolution(device=device, **config)
    return load_flax_variables(model, variables_numpy).eval()
