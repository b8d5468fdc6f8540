"""Post-training int8 quantisation of SuperResolutionNet for serving.

Counterpart of ``nerve_tpu/models/quantize.py``. :func:`quantize_sr` runs
one calibration forward in which every quantised site (the RDB stack with
``quantized``; with ``quantized_chains`` also the feature head, flow head,
attention logits, gff and upsampler convs) computes max-abs activation
scales from its own exact input, quantises its weights into its int8 state
and passes the exact result downstream. Usage::

    model = SuperResolutionNet(..., quantized=True, quantized_chains=True)
    quantize_sr(model, calib_frames)        # (B, T, H, W, C) windows
    carry = streaming_prime(model, frame0)  # then the same streaming calls

:func:`quantize_engine` does the same for an ``EnhancementEngine`` whose SR
net is quantised, on the windows the engine feeds that net: after
recovery, the recovered centre in place.
"""

from __future__ import annotations

import contextlib
from typing import List, Mapping, Optional

import torch
import torch.nn as nn

from nerve_tpu_torch.models.super_resolution import (
    RDBStack,
    SuperResolutionNet,
    resolve_device,
)
from nerve_tpu_torch.ops import rdb_int8


def rdb_params_from_tree(rdbs_params: Mapping[str, torch.Tensor], num_blocks: int,
                         num_layers: int = 5) -> List[List[torch.Tensor]]:
    """An RDB stack's named parameters (``dict(model.rdbs.named_parameters())``)
    → per-block flat float32 param lists (w_0, b_0, …, lw, lb)."""
    out = []
    for b in range(num_blocks):
        names = [f"rdb{b}_dense{i}_{k}" for i in range(num_layers)
                 for k in ("kernel", "bias")] + [f"rdb{b}_lff_kernel", f"rdb{b}_lff_bias"]
        out.append([rdbs_params[n].detach().float() for n in names])
    return out


class _Captured(Exception):
    """Stops a forward once the temporal aggregator's output is captured."""


@contextlib.contextmanager
def _quant_modes(model: SuperResolutionNet, chain_quant: str, rdb_calibrate: bool):
    """Every int8 chain site of ``model`` in mode ``chain_quant`` and every
    int8 RDB stack calibrating or not, for the body."""
    sites = [m for m in model.modules() if getattr(m, "chain_quant", "off") == "serve"]
    stacks = [m for m in model.modules() if isinstance(m, RDBStack) and m.quantized]
    for m in sites:
        m.chain_quant = chain_quant
    for m in stacks:
        m.quant_calibrate = rdb_calibrate
    try:
        yield
    finally:
        for m in sites:
            m.chain_quant = "serve"
        for m in stacks:
            m.quant_calibrate = False


@torch.inference_mode()
def calibrate_sr_scales(model: SuperResolutionNet, frames: torch.Tensor) -> torch.Tensor:
    """(num_blocks, 1 + num_layers) RDB activation scales from the RDB
    stack's input (the temporal aggregator's output, with every chain site
    exact) on ``frames`` (B, T, H, W, C), with the stack's float32
    parameters."""
    captured = []

    def hook(_mod, _inputs, output):
        captured.append(output)
        raise _Captured

    handle = model.temporal_aggregator.register_forward_hook(hook)
    try:
        with _quant_modes(model, "off", False):
            model(frames.to(next(model.parameters()).device))
    except _Captured:
        pass
    finally:
        handle.remove()
    params = rdb_params_from_tree(dict(model.rdbs.named_parameters()),
                                  model.rdbs.num_blocks, model.rdbs.num_layers)
    return rdb_int8.calibrate_rdb_chain(captured[0].float(), params)


def quantize_sr(model: SuperResolutionNet, frames: torch.Tensor,
                device="cuda") -> SuperResolutionNet:
    """Calibrate ``model``'s int8 state on ``frames`` (B, T, H, W, C), in place.

    The model moves to ``device`` (the card unless ``device="cpu"``) and to
    eval mode first; it is returned ready to serve. The RDB stack quantises
    in the scheme ``ops.rdb_int8.PER_CHANNEL_INT8`` names at this call
    (per-column by default) and must be served under the same setting.
    """
    if not (model.quantized or model.quantized_chains):
        raise ValueError("the model has no quantised site: build it with quantized=True "
                         "and/or quantized_chains=True")
    dev = resolve_device(device)
    model.to(dev).eval()
    with _quant_modes(model, "calibrate", True):
        model(frames.to(dev))
    return model


def quantize_engine(engine: nn.Module, frames: torch.Tensor,
                    corruption_mask: Optional[torch.Tensor] = None,
                    device="cuda") -> nn.Module:
    """Calibrate the int8 state of ``engine``'s SR net, in place, on one
    forward of the engine over ``frames`` (B, T, H, W, C) with
    ``corruption_mask`` (B, H, W, 1): each site takes its scales from what
    it is fed there, behind recovery. An ``AdaptiveEnhancementEngine`` runs
    its inner engine mask-free, as its forward does. Each int8 state packs
    its weights once, at its first serving call, as after ``quantize_sr``.
    The engine moves to ``device`` and eval mode first and is returned."""
    inner = getattr(engine, "engine", engine)
    sr = getattr(inner, "super_resolution", None)
    if not isinstance(sr, SuperResolutionNet) or not (sr.quantized or sr.quantized_chains):
        raise ValueError("the engine's SR net has no quantised site: build it with "
                         "sr_quantized=True and/or sr_quantized_chains=True")
    dev = resolve_device(device)
    engine.to(dev).eval()
    mask = corruption_mask if inner is engine else None
    with _quant_modes(sr, "calibrate", True):
        inner(frames.to(dev), None, None if mask is None else mask.to(dev))
    return engine
