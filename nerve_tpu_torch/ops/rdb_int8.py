"""Static post-training int8 residual dense block (RDB) chain.

Counterpart of ``nerve_tpu/ops/rdb_int8.py``, with both of its schemes.

Scheme: per-tensor symmetric int8 activations with static scales from a
calibration forward (:func:`calibrate_rdb_chain`: the block input and each
dense layer's relu output); per-column symmetric int8 weights on the packed
tap matrix, each row folded with the activation scale of the slot that owns
its input channel (:func:`_owner_scales`), so one factor per column
dequantises the int32 sum; exact float32 biases. ``per_channel``
quantisation shares one factor among an output channel's nine tap columns
(the largest of the nine), which lets the nine taps' int32 sums add in int32
and dequantise once (``int32_taps``). ``PER_CHANNEL_INT8`` (default False,
as in the JAX package) picks the scheme of the model's quantise and apply
calls, read at call time; ``DX_MAJOR_INT8`` the per-column tap order. The
wire format does not record the scheme, so ``int32_taps`` checks that a
chain's factors are tiled per channel and refuses a per-column chain.

Wire format per block (:func:`quantize_rdb_block`, the JAX package's):
``wq`` L+1 int8 matrices (dense layer i ``(FEAT_OFF + C + i·G, 9·G)``,
column ``(3·dy + dx)·G + n``; the fusion ``(FEAT_OFF + C + L·G, C)``; the
``FEAT_OFF`` leading rows are zero), ``dq`` float32 ``(L, 9·G)``, ``meta``
float32 ``(4, max(9·G, 2·C, L·G))``: row 0 the dense biases, row 1 the
fusion's dequant factors then its bias, row 2 s_in, row 3 each dense
layer's requant factor 1/s_f.

Numerics (``rdb_chain_int8_xla``): the chain input is quantised once by
division by block 0's s_in; each tap's int32 sum is dequantised and rounded
to bfloat16, the taps added in float32 (dy outer, dx inner; dx outer with
``dx_major``, as ``_rdb_int8_kernel`` does), or with ``int32_taps`` the nine
int32 sums added in int32 and the total times ``dq[i, :G]``; then float32
bias, relu, requantised by multiplication with row 3; the fusion is
``(lff·ldq + lbias)·0.2 + x_q·s_in`` on the int8 block input; between
blocks the result is requantised by division by the next block's s_in,
after the last block rounded to ``out_dtype``.

A CUDA tensor runs the hand-written kernels: ``nt_quantize_i8``
(``csrc/quantize_i8.cu``) quantises the stack's input into the first
block's int8 (B, H, W, C + L·G) concatenation buffer, the dense layers are
``nt_conv2d_i8`` (``csrc/conv_int8.cu``, in the tap schedule of the scheme)
writing into the slots of that buffer, and ``nt_rdb_lff_i8``
(``csrc/rdb_int8.cu``) fuses and requantises into channels [0, C) of the
other of two buffers (``ops.rdb.stack_plan``), the next block's input.
The blocks' weights are packed for the kernels by :func:`packed_rdb_chain`:
a caller that serves a stack many times packs it once and passes the packs
(the models keep them with their int8 state); without them a call packs at
every call.
Any geometry (C, L, G) runs on the kernels; one whose layer does not fit a
block's shared memory raises. A CPU tensor runs ``rdb_chain_int8_plain``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from nerve_tpu_torch.ops import _build, dispatch
from nerve_tpu_torch.ops.conv_chain import conv_chain_plain
from nerve_tpu_torch.ops.conv_chain_int8 import (
    CHUNK_I8,
    QMAX,
    TAPS_DX,
    TAPS_DY,
    TAPS_INT32,
    PackedLayerI8,
    _ceil_to,
    conv_layer_launch_i8,
    exact_float32,
    int_products,
    pack_i8_weights,
    quantize_activation,
    quantize_into,
)
from nerve_tpu_torch.ops.rdb import stack_plan

FEAT_OFF = 8  # leading zero rows of the wire format's weight matrices
GROWTH = 32
NUM_LAYERS = 5
RES_SCALE = 0.2
LFF_N_TILE = 32  # the int8 fusion kernel's output-channel tile (csrc NT_LFF_I8_N_TILE)
# The scheme switches of the JAX module (rdb_int8.py:67, :75), read at call
# time. PER_CHANNEL_INT8 must be the same when a model is quantised and when
# it is served.
DX_MAJOR_INT8 = False
PER_CHANNEL_INT8 = False


def calibrate_rdb_chain(x: torch.Tensor, params_list: Sequence) -> torch.Tensor:
    """(num_blocks, 1 + L) scales ``[s_in, s_f0, …]`` per block: max-abs / 127
    of the block input and of each dense layer's relu output, from the exact
    float32 chain on ``x``. Any block geometry."""
    x = x.float()
    rows = []
    with exact_float32():
        for params in params_list:
            ps = [torch.as_tensor(p).float() for p in params]
            lw, lb = ps[-2], ps[-1]
            maxes = [x.abs().max()]
            feats = [x]
            for i in range(len(ps) // 2 - 1):
                f = conv_chain_plain(torch.cat(feats, dim=-1), [(ps[2 * i], ps[2 * i + 1], "relu")])
                feats.append(f)
                maxes.append(f.abs().max())
            lff = torch.matmul(torch.cat(feats, dim=-1), lw) + lb
            x = lff * RES_SCALE + x
            rows.append(torch.stack(maxes))
    return torch.stack(rows) / QMAX


def _owner_scales(features: int, k: int, scales: torch.Tensor,
                  growth: int = GROWTH) -> torch.Tensor:
    """Activation scale owning each of the first ``k`` concatenation channels:
    [0, FEAT_OFF) and the block input take s_in, then ``growth``-wide runs
    take each dense layer's scale."""
    owner = [0] * (FEAT_OFF + features)
    i = 0
    while len(owner) < k:
        owner += [1 + i] * growth
        i += 1
    return scales[torch.tensor(owner[:k], device=scales.device)]


def _quantize_columns(m: torch.Tensor, per_channel_of: int = 0):
    """Per-column int8; with ``per_channel_of`` = G, each output channel's
    nine tap columns share the largest of their factors."""
    col = torch.clamp(m.abs().amax(dim=0), min=1e-12) / QMAX
    if per_channel_of:
        col = col.reshape(9, per_channel_of).amax(dim=0).repeat(9)
    return torch.clamp(torch.round(m / col), -QMAX, QMAX).to(torch.int8), col


def quantize_rdb_block(params: Sequence[torch.Tensor], features: int,
                       scales: torch.Tensor, per_channel: bool = False,
                       ) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """One block's params + activation scales → ``(wq, dq, meta)`` in the
    wire format (module docstring). L and G come from ``params``. With
    ``per_channel``, ``dq[i, :G]`` holds the per-channel factors (tiled over
    the nine taps, the same wire format)."""
    scales = scales.float()
    ps = [torch.as_tensor(p).float() for p in params]
    num_layers = len(ps) // 2 - 1
    growth = ps[0].shape[3]
    ntap = 9 * growth
    wq, dqs = [], []
    for i in range(num_layers):
        w = ps[2 * i]
        ki = FEAT_OFF + features + growth * i
        wp = F.pad(w, (0, 0, FEAT_OFF, ki - FEAT_OFF - w.shape[2]))
        wcat = wp.permute(2, 0, 1, 3).reshape(ki, ntap)
        q, col = _quantize_columns(wcat * _owner_scales(features, ki, scales, growth)[:, None],
                                   growth if per_channel else 0)
        wq.append(q)
        dqs.append(col)
    lw, lb = ps[-2], ps[-1]
    kl = FEAT_OFF + features + growth * num_layers
    lwp = F.pad(lw, (0, 0, FEAT_OFF, kl - FEAT_OFF - lw.shape[0]))
    q, lcol = _quantize_columns(lwp * _owner_scales(features, kl, scales, growth)[:, None])
    wq.append(q)

    meta = torch.zeros((4, max(ntap, 2 * features, num_layers * growth)),
                       dtype=torch.float32, device=lw.device)
    meta[0, :num_layers * growth] = torch.cat([ps[2 * i + 1] for i in range(num_layers)])
    meta[1, :features] = lcol
    meta[1, features:2 * features] = lb
    meta[2, :] = scales[0]
    meta[3, :num_layers * growth] = torch.repeat_interleave(1.0 / scales[1:], growth)
    return wq, torch.stack(dqs), meta


def quantize_rdb_chain(params_list: Sequence, scales: torch.Tensor, per_channel: bool = False):
    """Whole-chain quantisation: a tuple of per-block ``(wq, dq, meta)``."""
    features = params_list[0][0].shape[2]
    return tuple(quantize_rdb_block(params, features, scales[b], per_channel)
                 for b, params in enumerate(params_list))


def _schemes(int32_taps, dx_major) -> Tuple[bool, bool]:
    """The call's ``(int32_taps, dx_major)``, None taking the module switches."""
    return (PER_CHANNEL_INT8 if int32_taps is None else bool(int32_taps),
            DX_MAJOR_INT8 if dx_major is None else bool(dx_major))


def chain_geometry(qchain) -> Tuple[int, int]:
    """(num_layers, growth) of a quantised chain's wire format."""
    wq = qchain[0][0]
    return len(wq) - 1, wq[0].shape[1] // 9


def _check_chain(qchain, features: int, int32_taps: bool = False) -> Tuple[int, int]:
    """(L, G) of ``qchain`` on ``features`` channels; raises on a mismatch,
    and, for ``int32_taps``, on a chain quantised per column (its factors not
    one per output channel tiled over the nine taps: ``dq[i, :G]`` would
    dequantise every tap by the (0, 0) tap's)."""
    num_layers, growth = chain_geometry(qchain)
    for b, (wq, dq, meta) in enumerate(qchain):
        shapes = [tuple(w.shape) for w in wq]
        want = [(FEAT_OFF + features + growth * i, 9 * growth) for i in range(num_layers)]
        want.append((FEAT_OFF + features + growth * num_layers, features))
        width = max(9 * growth, 2 * features, num_layers * growth)
        if (shapes != want or tuple(dq.shape) != (num_layers, 9 * growth)
                or tuple(meta.shape) != (4, width)):
            raise ValueError(f"int8 RDB block {b}: wq {shapes}, dq {tuple(dq.shape)}, meta "
                             f"{tuple(meta.shape)} do not fit C={features}, L={num_layers}, "
                             f"G={growth}")
    if int32_taps:
        dqs = torch.stack([dq for _wq, dq, _meta in qchain])
        if not torch.equal(dqs, dqs[..., :growth].repeat(1, 1, 9)):
            raise ValueError("int32_taps takes a chain quantised per channel "
                             "(quantize_rdb_chain(..., per_channel=True)); this one is per column")
    return num_layers, growth


def rdb_chain_int8_plain(x: torch.Tensor, qchain, out_dtype=None, int32_taps=None,
                         dx_major=None) -> torch.Tensor:
    """Plain version, step by step the arithmetic of ``rdb_chain_int8_xla``
    (and, with ``dx_major``, of the Pallas kernel's dx-outer tap order).
    int8 values are carried as integer-valued float32 (exact: one tap's sum
    is below 2²⁴), the int32 tap sums of ``int32_taps`` as int32; the
    concatenation leaves out the ``FEAT_OFF`` zero channels, whose weight
    rows are zero."""
    out_dtype = out_dtype or x.dtype
    int32_taps, dx_major = _schemes(int32_taps, dx_major)
    features = x.shape[-1]
    num_layers, growth = _check_chain(qchain, features, int32_taps)
    xq = quantize_activation(x, qchain[0][2][2, 0]).float()
    with exact_float32():
        for b, (wq, dq, meta) in enumerate(qchain):
            _bsz, h, w, _ = xq.shape
            feats = [xq]
            for i in range(num_layers):
                inp = torch.cat(feats, dim=-1)
                wi = wq[i][FEAT_OFF:]
                pad = F.pad(inp, (0, 0, 1, 1, 1, 1))
                taps = {}  # (dy, dx) -> that tap's int32 sum, as exact float32
                for dy in range(3):
                    yi = int_products(pad[:, dy:dy + h], wi[:, 3 * dy * growth:(3 * dy + 3) * growth])
                    for dx in range(3):
                        taps[dy, dx] = yi[:, :, dx:dx + w, dx * growth:(dx + 1) * growth]
                if int32_taps:
                    acci = sum(t.to(torch.int32) for t in taps.values())
                    acc = acci.float() * dq[i, :growth]
                else:
                    acc = torch.zeros((*inp.shape[:3], growth), dtype=torch.float32,
                                      device=x.device)
                    for dy, dx in sorted(taps, key=lambda t: t[::-1] if dx_major else t):
                        c0 = (3 * dy + dx) * growth
                        yb = (taps[dy, dx] * dq[i, c0:c0 + growth]).to(torch.bfloat16)
                        acc = acc + yb.float()
                f = torch.relu(acc + meta[0, i * growth:(i + 1) * growth])
                feats.append(torch.clamp(
                    torch.round(f * meta[3, i * growth:(i + 1) * growth]), -QMAX, QMAX))
            last = b == len(qchain) - 1
            out = lff_plain_i8(torch.cat(feats, dim=-1), wq[num_layers][FEAT_OFF:],
                               meta[1, :features], meta[1, features:2 * features], meta[2, 0],
                               None if last else qchain[b + 1][2][2, 0],
                               out_dtype if last else torch.int8)
            if last:
                return out
            xq = out.float()
    raise ValueError("empty int8 RDB chain")


def lff_plain_i8(cat: torch.Tensor, wl: torch.Tensor, ldq: torch.Tensor, lbias: torch.Tensor,
                 s_in: torch.Tensor, s_next, out_dtype=torch.int8) -> torch.Tensor:
    """Plain version of the int8 fusion on the leading ``ccat`` channels of
    the integer-valued ``cat`` (``wl`` the int8 wire rows (ccat, C)):
    ``v = (lff·ldq + lbias)·0.2 + cat[..., :C]·s_in`` with ``lff`` the int32
    products; int8 ``clip(rint(v / s_next), ±127)`` (true division), or v
    rounded to ``out_dtype``."""
    ccat, c = wl.shape
    xq = cat[..., :ccat].float()
    with exact_float32():
        v = (int_products(xq, wl) * ldq + lbias) * RES_SCALE + xq[..., :c] * s_in
    if out_dtype != torch.int8:
        return v.to(out_dtype)
    return torch.clamp(torch.round(v / s_next), -QMAX, QMAX).to(torch.int8)


class PackedBlockI8(NamedTuple):
    """One int8 block as the kernels take it: its dense layers and the
    fusion's int8 weight image (``pack_i8_weights`` of the (C + L·G, C) wire
    rows at the fusion's N tile ``LFF_N_TILE``)."""

    layers: List[PackedLayerI8]
    lw: torch.Tensor


def packed_block(block, features: int, num_layers: int, growth: int,
                 int32_taps: bool) -> PackedBlockI8:
    """A block's ``(wq, dq, meta)`` packed for the kernels; ``int32_taps``
    takes the per-channel factors ``dq[i, :G]``."""
    wq, dq, meta = block
    layers = [PackedLayerI8(pack_i8_weights(wq[i][FEAT_OFF:], 9, growth, growth),
                            (dq[i, :growth] if int32_taps else dq[i]).contiguous(),
                            meta[0, i * growth:(i + 1) * growth].contiguous(),
                            meta[3, i * growth:(i + 1) * growth].contiguous(),
                            9, features + growth * i, growth)
              for i in range(num_layers)]
    lw = pack_i8_weights(wq[num_layers][FEAT_OFF:], 1, features, features, LFF_N_TILE)
    return PackedBlockI8(layers, lw)


def packed_rdb_chain(qchain, int32_taps=None) -> List[PackedBlockI8]:
    """Every block of ``qchain`` packed for the kernels in the scheme
    ``int32_taps`` (default ``PER_CHANNEL_INT8``; counted in
    ``dispatch.packs``)."""
    int32_taps, _ = _schemes(int32_taps, None)
    num_layers, growth = chain_geometry(qchain)
    features = qchain[0][0][-1].shape[1]
    packs = [packed_block(block, features, num_layers, growth, int32_taps)
             for block in qchain]
    dispatch.packs["int8"] += 1
    return packs


def lff_image_size(ccat: int, c: int) -> int:
    """Bytes of the int8 fusion's weight image for ``ccat`` → ``c`` channels."""
    return _ceil_to(c, LFF_N_TILE) * _ceil_to(ccat, CHUNK_I8)


def lff_launch_i8(cat: torch.Tensor, ccat: int, lw: torch.Tensor, ldq: torch.Tensor,
                  lbias: torch.Tensor, s_in: torch.Tensor, s_next: torch.Tensor,
                  out: torch.Tensor, out_coff: int = 0) -> None:
    """Launch ``nt_rdb_lff_i8``: fuse channels [0, ccat) of the int8 ``cat``
    into channels [out_coff, out_coff + C) of ``out`` (int8 requantised at
    ``s_next``, or the real value in bfloat16/float32), which must not share
    ``cat``'s storage. ``lw`` is the fusion's weight image
    (``PackedBlockI8.lw``)."""
    b, h, w, ccs = cat.shape
    c = ldq.shape[0]
    if (tuple(lw.shape) != (lff_image_size(ccat, c),) or not c <= ccat <= ccs or ccs % 16
            or tuple(ldq.shape) != (c,) or tuple(lbias.shape) != (c,)
            or s_in.numel() < 1 or s_next.numel() < 1 or out.shape[:3] != cat.shape[:3]
            or out_coff < 0 or out_coff + c > out.shape[-1]):
        raise ValueError(f"int8 RDB fusion: weight image {tuple(lw.shape)}, factors "
                         f"{tuple(ldq.shape)}/{tuple(lbias.shape)} or output "
                         f"{tuple(out.shape)} at {out_coff} do not fit {ccat} of {ccs} input "
                         "channels")
    tensors = (cat, lw, ldq, lbias, s_in, s_next, out)
    if not (cat.dtype == lw.dtype == torch.int8 and ldq.dtype == lbias.dtype == s_in.dtype
            == s_next.dtype == torch.float32 and all(t.is_contiguous() for t in tensors)
            and cat.data_ptr() % 16 == 0 and lw.data_ptr() % 16 == 0):
        raise ValueError("int8 RDB fusion takes contiguous int8 activations and weights "
                         "(16-byte aligned) and float32 factors")
    if out.untyped_storage().data_ptr() == cat.untyped_storage().data_ptr():
        raise ValueError("int8 RDB fusion output shares the concatenation buffer's storage")
    _build.launch("nt_rdb_lff_i8", cat.device, cat.data_ptr(), ccs, ccat, lw.data_ptr(),
                  ldq.data_ptr(), lbias.data_ptr(), s_in.data_ptr(), s_next.data_ptr(),
                  out.data_ptr(), out.shape[-1], out_coff, c, b, h, w, _build.dtype_code(out))
    dispatch.launches["rdb_lff_i8"] += 1


def rdb_chain_int8_apply(x: torch.Tensor, qchain, out_dtype=None, int32_taps=None,
                         dx_major=None, packed=None) -> torch.Tensor:
    """The quantised RDB stack: (B, H, W, C) → (B, H, W, C) in ``out_dtype``
    (default: x's), int8 between blocks. ``int32_taps`` (default
    ``PER_CHANNEL_INT8``) takes a per-channel chain; ``dx_major`` (default
    ``DX_MAJOR_INT8``) orders a per-column chain's taps dx outer.
    ``packed``: ``packed_rdb_chain(qchain, int32_taps)``, or None to pack at
    this call (the kernels' path only)."""
    out_dtype = out_dtype or x.dtype
    int32_taps, dx_major = _schemes(int32_taps, dx_major)
    b, h, w, c = x.shape
    num_layers, growth = _check_chain(qchain, c, int32_taps)
    if not dispatch.use_kernel(x, *(t for wq, dq, meta in qchain for t in (*wq, dq, meta))):
        return rdb_chain_int8_plain(x, qchain, out_dtype, int32_taps, dx_major)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8 RDB output must be float32 or bfloat16, got {out_dtype}")
    ccat = c + num_layers * growth
    # Two concatenation buffers (stack_plan): block k reads one and writes
    # the next block's int8 input into channels [0, C) of the other.
    cats = [torch.empty((b, h, w, _ceil_to(ccat, 16)), dtype=torch.int8, device=x.device)
            for _ in range(min(len(qchain), 2))]
    quantize_into([x], qchain[0][2][2, :1], cats[0], c)
    out = None
    mode = TAPS_INT32 if int32_taps else TAPS_DX if dx_major else TAPS_DY
    packed = packed_rdb_chain(qchain, int32_taps) if packed is None else packed
    if len(packed) != len(qchain):
        raise ValueError(f"{len(packed)} packed blocks for a stack of {len(qchain)}")
    for k, ((src, dst), (wq, dq, meta), block) in enumerate(
            zip(stack_plan(len(qchain)), qchain, packed)):
        cat = cats[src]
        for layer in block.layers:
            conv_layer_launch_i8(cat, layer, cat, layer.cin, relu=True, taps_mode=mode)
        if dst is None:
            out = torch.empty((b, h, w, c), dtype=out_dtype, device=x.device)
            s_next = meta[2, :1]
        else:
            out, s_next = cats[dst], qchain[k + 1][2][2, :1]
        lff_launch_i8(cat, ccat, block.lw, meta[1, :c], meta[1, c:2 * c], meta[2, :1], s_next,
                      out)
        dispatch.launches["rdb_int8"] += 1
        if int32_taps:
            dispatch.launches["rdb_int8_int32_taps"] += 1
    return out
