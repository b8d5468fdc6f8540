"""The residual dense block under the TPU kernels' own rounding contracts.

The block is the function of ``ops.rdb``; the TPU kernels that compute it
differ in how each dense layer's nine tap sums are grouped and rounded.
Each Pallas tap matmul sums its products in float32 and rounds the result
to the activation dtype; the bias rides in the matmul of the centre tap as
a product with a ones channel; the rounded matmul outputs are added in
float32 (or in the dtype), then relu and a round to the dtype. The fusion
and residual compute ``(Σ cat·lw + lb)·0.2 + x`` in float32 and round once.
A contract is therefore an ordered list of tap groups per output-row
parity, the taps named ``(dy, dx)``:

============  ===========================================================
``pallas_dy`` nine single taps, dy outer: ``scripts/diag_rdb.py``
              ``flat_strips``, ``flat_dy_pet_strips``, ``chunk_strips_full``,
              ``chunk_negmask``, ``full``, ``flat``, ``chunk_dy_bf16``,
              ``chunk_dy_pet``; ``nerve_tpu/ops/rdb.py`` with
              ``DX_MAJOR = False``
``pallas_dx`` nine single taps, dx outer: the ``flat_dx_*strips*`` modes
              other than ``f32y``/``accbf16``, ``chunk_dx``,
              ``chunk_dx_pet``; ``nerve_tpu/ops/rdb.py`` as it ships
              (``DX_MAJOR = True``)
``f32_taps``  one group of all nine (+ bias): ``flat_dx_strips_f32y``,
              ``chunk_dy``, ``chunk_tap``
``acc_dtype`` nine single taps, dx outer, the accumulator rounded to the
              dtype after every add: ``flat_dx_strips_accbf16``,
              ``flat_dx_strips_xonce_accbf16``
``s2d``       ``scripts/diag_rdb_s2d.py`` ``rdb_s2d``: even rows the pairs
              {(1, dx), (2, dx)} for dx = 0, 1, 2, then the singles (0, dx);
              odd rows the pairs {(0, dx), (1, dx)}, then the singles (2, dx);
              any H (a row's parity is its index's; ``rdb_s2d`` took even H)
============  ===========================================================

``diag_rdb.py``'s ``full``, ``flat``, ``chunk_dy*``, ``chunk_dx*`` and
``chunk_tap`` modes do not re-zero out-of-image pixels between layers and so
feed a layer the relu(bias) values of the previous one's halo within five
pixels of an image border; the port's per-layer kernel pads every layer with
zeros, so each of them maps to its contract above with SAME padding. The
harness also writes the bias's ones channel only at its first grid step;
on a grid of several tiles, boundary tiles wipe it and later tiles lose
their biases. The port computes the contracts, not that fault.

Three ablations of ``diag_rdb.py`` time parts of the work and are not the
block. Each walks ``pallas_dx``'s taps and groups, so their times subtract
from its: ``noshift`` (every group computed and rounded, each layer's
output relu(round(centre tap + bias)) alone), ``nolff`` (the dense layers
run, the block returns its input) and ``matonly`` (each group's sum folded
into the accumulator unrounded, each layer stores one token per warp; no
plain version, as the harness compares nothing for it).

A CUDA tensor runs ``nt_rdb_taps_conv`` (``csrc/rdb_taps.cu``) once per
dense layer into the slots of a (B, H, W, ceil8(C + L·G)) concatenation buffer,
then ``nt_rdb_lff`` (``csrc/rdb.cu``); a CPU tensor runs ``rdb_taps_plain``.
Weights and biases take the activation dtype's values, as the Pallas
kernels pack them at the parameters' dtype.

In bfloat16 the layer runs on warpgroup products, one float32 accumulator
set per group held over all of cin: the kernel maps each tap to a set at
compile time per contract family and output-row parity (``FAMILIES``, the
kernel's ``SET_OF`` and ``FOLD``; ``accumulator_plan``), and takes its
weights packed per call by ``ops.conv_chain.pack_conv_weights`` at the N
tile ``n_tile``. ``launch_record`` says how a layer launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from nerve_tpu_torch.ops import _build, dispatch
from nerve_tpu_torch.ops.conv_chain import pack_conv_weights
from nerve_tpu_torch.ops.conv_chain_int8 import exact_float32
from nerve_tpu_torch.ops.rdb import RES_SCALE, lff_launch

Tap = Tuple[int, int]
Groups = List[Tuple[Tap, ...]]

_DY = [(dy, dx) for dy in range(3) for dx in range(3)]
_DX = [(dy, dx) for dx in range(3) for dy in range(3)]
CENTRE = (1, 1)

# name -> (groups of even output rows, of odd rows, accumulator in the dtype)
CONTRACTS: Dict[str, Tuple[Groups, Groups, bool]] = {
    "pallas_dy": ([(t,) for t in _DY], [(t,) for t in _DY], False),
    "pallas_dx": ([(t,) for t in _DX], [(t,) for t in _DX], False),
    "f32_taps": ([tuple(_DY)], [tuple(_DY)], False),
    "acc_dtype": ([(t,) for t in _DX], [(t,) for t in _DX], True),
    "s2d": ([((1, dx), (2, dx)) for dx in range(3)] + [((0, dx),) for dx in range(3)],
            [((0, dx), (1, dx)) for dx in range(3)] + [((2, dx),) for dx in range(3)], False),
}
ABLATIONS = ("noshift", "nolff", "matonly")  # each walks pallas_dx's groups
MODES = (*CONTRACTS, *ABLATIONS)
# The C flags (csrc/nerve_tpu_torch.h).
_ACC_DTYPE, _NOSHIFT, _MATONLY = 1, 2, 4

# The bf16 kernel's contract families (csrc/rdb_taps.cu ``SET_OF``, ``FOLD``):
# family -> (the accumulator set of each tap t = 3·dy + dx for even and for
# odd output rows, the sets in the order the epilogue adds them).
FAMILIES: Dict[str, Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], Tuple[int, ...]]] = {
    "pallas_dy": ((tuple(range(9)), tuple(range(9))), tuple(range(9))),
    "pallas_dx": ((tuple(range(9)), tuple(range(9))), (0, 3, 6, 1, 4, 7, 2, 5, 8)),
    "f32_taps": (((0,) * 9, (0,) * 9), (0,)),
    "s2d": (((3, 4, 5, 0, 1, 2, 0, 1, 2), (0, 1, 2, 0, 1, 2, 3, 4, 5)), tuple(range(6))),
}
# acc_dtype and the ablations walk pallas_dx's groups.
FAMILY_OF = {**{m: m for m in FAMILIES}, "acc_dtype": "pallas_dx",
             **dict.fromkeys(ABLATIONS, "pallas_dx")}
LAUNCH_RECORD = ("grid", "threads", "dynamic_smem_bytes", "static_smem_bytes", "registers",
                 "spill_bytes", "tiles", "n_tile", "stages", "resident_weights",
                 "accumulator_sets")


def n_tile(cout: int) -> int:
    """The bf16 kernel's output-channel tile (wgmma N) for ``cout`` channels:
    16 or 32, wider layers walking 32-wide tiles."""
    return 16 if cout <= 16 else 32


def accumulator_plan(mode: str):
    """``mode``'s family in the bf16 kernel: (the set of each tap for even
    and odd rows, the sets in fold order)."""
    if mode not in MODES:
        raise ValueError(f"unknown RDB tap mode {mode!r}; one of {MODES}")
    return FAMILIES[FAMILY_OF[mode]]


# Each mode of the TPU harnesses -> the port's contract.
TPU_MODES = {
    **dict.fromkeys(("flat_strips", "flat_dy_pet_strips", "chunk_strips_full", "chunk_negmask",
                     "full", "flat", "chunk_dy_bf16", "chunk_dy_pet"), "pallas_dy"),
    **dict.fromkeys(("flat_dx_strips", "flat_dx_pet_strips", "flat_dx_strips_xonce",
                     "flat_dx_selmm_strips", "flat_dx_strips_pipe", "flat_dx_strips_pipe3",
                     "chunk_dx", "chunk_dx_pet"), "pallas_dx"),
    **dict.fromkeys(("flat_dx_strips_f32y", "chunk_dy", "chunk_tap"), "f32_taps"),
    **dict.fromkeys(("flat_dx_strips_accbf16", "flat_dx_strips_xonce_accbf16"), "acc_dtype"),
    "rdb_s2d": "s2d", "noshift": "noshift", "nolff": "nolff", "matonly": "matonly",
}


def _contract(mode: str) -> Tuple[Groups, Groups, bool]:
    if mode not in MODES:
        raise ValueError(f"unknown RDB tap mode {mode!r}; one of {MODES}")
    return CONTRACTS["pallas_dx" if mode in ABLATIONS else mode]


def launch_table(mode: str) -> Tuple[List[int], int]:
    """The mode's C table (20 ints: each parity's walk of t = 3·dy + dx, then
    each parity's group-end bit mask) and flags."""
    even, odd, acc_dtype = _contract(mode)
    walks, ends = [], []
    for groups in (even, odd):
        taps = [t for grp in groups for t in grp]
        if sorted(taps) != _DY:
            raise ValueError(f"tap groups {groups} do not cover the nine taps once")
        walks += [3 * dy + dx for dy, dx in taps]
        pos, mask = 0, 0
        for grp in groups:
            pos += len(grp)
            mask |= 1 << (pos - 1)
        ends.append(mask)
    flags = ((_ACC_DTYPE if acc_dtype else 0) | (_NOSHIFT if mode == "noshift" else 0)
             | (_MATONLY if mode == "matonly" else 0))
    return walks + ends, flags


def _tap_sums(inp: torch.Tensor, w: torch.Tensor) -> Dict[Tap, torch.Tensor]:
    """Each tap's float32 sum over the input channels, SAME zero padding."""
    _b, h, wd, _k = inp.shape
    pad = F.pad(inp.float(), (0, 0, 1, 1, 1, 1))
    with exact_float32():
        return {(dy, dx): torch.matmul(pad[:, dy:dy + h, dx:dx + wd], w[dy, dx].float())
                for dy, dx in _DY}


def layer_plain(inp: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                mode: str = "pallas_dx") -> torch.Tensor:
    """Plain version of one dense layer: ``w`` (3, 3, K, G) and ``bias`` at
    ``inp``'s dtype; the groups summed, rounded and added as the mode says."""
    even, odd, acc_dtype = _contract(mode)
    dt = inp.dtype
    taps = _tap_sums(inp, w)
    out = torch.empty((*inp.shape[:3], w.shape[-1]), dtype=dt, device=inp.device)
    for par, groups in enumerate((even, odd)):
        acc = 0.0
        for grp in groups:
            s = taps[grp[0]][:, par::2]
            for t in grp[1:]:
                s = s + taps[t][:, par::2]
            if CENTRE in grp:
                s = s + bias.float()
            r = s.to(dt).float()
            if mode == "noshift":
                acc = r if CENTRE in grp else acc
                continue
            acc = acc + r
            if acc_dtype:
                acc = acc.to(dt).float()
        out[:, par::2] = torch.relu(acc).to(dt)
    return out


def _check(x: torch.Tensor, params: Sequence[torch.Tensor]) -> Tuple[int, int]:
    """(L, C + L·G) of ``params`` on ``x``; raises on a mismatch."""
    c = x.shape[-1]
    num_layers = len(params) // 2 - 1
    ctot = c
    for i in range(num_layers):
        w, b = params[2 * i], params[2 * i + 1]
        if tuple(w.shape[:3]) != (3, 3, ctot) or tuple(b.shape) != (w.shape[3],):
            raise ValueError(f"RDB dense layer {i}: weight {tuple(w.shape)} / bias "
                             f"{tuple(b.shape)} do not fit {ctot} input channels")
        ctot += w.shape[3]
    lw, lb = params[-2], params[-1]
    if tuple(lw.shape) != (ctot, c) or tuple(lb.shape) != (c,):
        raise ValueError(f"RDB fusion weight {tuple(lw.shape)} / bias {tuple(lb.shape)} "
                         f"does not fit {ctot} -> {c} channels")
    return num_layers, ctot


def rdb_taps_plain(x: torch.Tensor, params: Sequence[torch.Tensor],
                   mode: str = "pallas_dx") -> torch.Tensor:
    """Plain version of one block (B, H, W, C) under ``mode``."""
    _contract(mode)
    if mode == "matonly":
        raise ValueError("matonly is a timing ablation and has no plain version")
    num_layers, _ctot = _check(x, params)
    if mode == "nolff":
        return x.clone()
    dt = x.dtype
    feats = [x]
    for i in range(num_layers):
        feats.append(layer_plain(torch.cat(feats, dim=-1), params[2 * i].to(dt),
                                 params[2 * i + 1].to(dt), mode))
    with exact_float32():
        lff = (torch.matmul(torch.cat(feats, dim=-1).float(), params[-2].to(dt).float())
               + params[-1].to(dt).float())
    return (lff * RES_SCALE + x.float()).to(dt)


def contract_margin(y: torch.Tensor, x: torch.Tensor, params: Sequence[torch.Tensor],
                    contract: str) -> Tuple[float, float]:
    """Which contract ``y`` (a block's output on ``x``) computes:
    (mean|y − plain(contract)|, the least mean|y − plain(k)| over the other
    contracts k). ``pallas_dy`` and ``pallas_dx``, which differ only in
    float32 add order, count as one contract."""
    family = {"pallas_dy", "pallas_dx"} if contract.startswith("pallas") else {contract}

    def dist(k):
        return (y.float() - rdb_taps_plain(x, params, k).float()).abs().mean().item()

    return dist(contract), min(dist(k) for k in CONTRACTS if k not in family)


def rdb_taps_apply(x: torch.Tensor, params: Sequence[torch.Tensor],
                   mode: str = "pallas_dx") -> torch.Tensor:
    """One residual dense block (B, H, W, C) → (B, H, W, C) under ``mode``
    (a contract of ``CONTRACTS`` or an ablation of ``ABLATIONS``)."""
    table, flags = launch_table(mode)
    if not dispatch.use_kernel(x, *params):
        return rdb_taps_plain(x, params, mode)
    num_layers, ctot = _check(x, params)
    b, h, w, c = x.shape
    dt = x.dtype
    # A channel stride of a multiple of 8: the fusion reads the buffer
    # through TMA (16-byte pixel strides).
    ccs = -(-ctot // 8) * 8
    cat = torch.empty((b, h, w, ccs), dtype=dt, device=x.device)
    cat[..., :c] = x
    ctable = (ctypes.c_int * len(table))(*table)
    off = c
    for i in range(num_layers):
        wl = params[2 * i]
        cout = wl.shape[-1]
        # bf16: the B operand's image at the N tile; float32: HWIO as it is.
        wk = (pack_conv_weights(wl.to(dt), n_tile(cout)) if dt == torch.bfloat16
              else wl.float().contiguous())
        bk = params[2 * i + 1].to(dt).float().contiguous()
        _build.launch("nt_rdb_taps_conv", x.device, cat.data_ptr(), ccs, off, wk.data_ptr(),
                      bk.data_ptr(), cat.data_ptr(), ccs, off, cout, b, h, w, ctable,
                      flags, _build.dtype_code(x))
        off += cout
    out = cat[..., :c].contiguous() if mode == "nolff" else lff_launch(
        cat, params[-2].to(dt), params[-1].to(dt))
    dispatch.launches["rdb_taps"] += 1
    return out


def launch_record(x: torch.Tensor, cin: int, cout: int, mode: str = "pallas_dx") -> dict:
    """What one bf16 dense layer of ``rdb_taps_apply`` launches for a block
    on ``x`` (B, H, W, C) reading ``cin`` channels of its buffer, without
    launching it: grid, threads, shared memory, the kernel's registers and
    spill bytes (``cudaFuncGetAttributes``), tiles, N tile, stages a ring,
    whether the weights stay resident, and the accumulator sets."""
    if not dispatch.use_kernel(x) or x.dtype != torch.bfloat16:
        raise ValueError("the launch record is the card's bf16 kernel's: pass a CUDA bf16 tensor")
    table, _flags = launch_table(mode)
    b, h, w, _c = x.shape
    ccs = -(-max(cin, x.shape[-1]) // 8) * 8  # the block buffer's channel stride
    rec = (ctypes.c_int * len(LAUNCH_RECORD))()
    _build.launch("nt_rdb_taps_launch", x.device, x.data_ptr(), ccs, cin, cout, b, h, w,
                  (ctypes.c_int * len(table))(*table), ctypes.addressof(rec))
    return dict(zip(LAUNCH_RECORD, rec))
