"""Load the JAX package's flax variables into the port's modules.

The port's modules carry the flax tree's names, so a flax path
``params/feature_extractor/head/kernel`` is ``state_dict()`` key
``feature_extractor.head.kernel`` and a ``batch_stats`` path is the
BatchNorm buffer of the same name. Layouts are the same too (HWIO
kernels, the RDB fusion as a 2-D matrix), so loading is a copy. It is
strict: a missing, unused or misshapen entry raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from nerve_tpu_torch.models.super_resolution import SuperResolutionNet

COLLECTIONS = ("params", "batch_stats")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def load_flax_variables(module: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Copy a flax ``{"params", "batch_stats"}`` tree (numpy leaves) into
    ``module``'s parameters and buffers, strictly."""
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
    with torch.no_grad():
        for k, t in state.items():
            arr = flat[k]
            if arr.shape != tuple(t.shape):
                raise ValueError(f"{k}: flax shape {arr.shape}, module shape {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.asarray(arr, dtype=np.float32)))
    return module


def sr_from_flax(variables_numpy: Mapping[str, Any], device=None,
                 **config) -> SuperResolutionNet:
    """A ``SuperResolutionNet(**config)`` in eval mode holding the flax weights."""
    model = SuperResolutionNet(device=device, **config)
    return load_flax_variables(model, variables_numpy).eval()
