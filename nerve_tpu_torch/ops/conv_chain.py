"""Sequential chains of SAME 3×3 / 1×1 convolutions with relu or none.

Counterpart of ``nerve_tpu/ops/conv_chain.py``. ``params`` is a sequence of
``(kernel, bias, act)``: kernel HWIO ``(k, k, cin, cout)`` with k ∈ {1, 3},
or rank-3 ``(3, 3, C)`` for a depthwise 3×3 layer; act ∈ {"relu", "none"}.
The input may be a list of tensors, concatenated on channels.

Numerics are those of the reference formulation ``_chain_xla``: weights
rounded to the input dtype, float32 accumulation, the convolution's sum
rounded to the input dtype, float32 bias, activation, the layer's output
rounded to the input dtype.

A CUDA tensor runs one launch per layer: ``csrc/conv_chain.cu`` for a
dense layer (counter ``conv_chain``), ``csrc/dwconv3.cu`` for a depthwise
one (counter ``conv_chain_dw3``). A CPU tensor runs ``conv_chain_plain``
(``F.conv2d``).

The depthwise kernel takes the float32 ``(3, 3, C)`` weights as they are
and rounds them itself, so a depthwise layer is one launch and one
``torch.empty``. It has two routes, chosen by shape (``dwconv3_route``):
``"tma"`` (persistent blocks fed by TMA boxes) where a pixel is a multiple
of 16 bytes and both tensors are 16-byte aligned, ``"tile"`` (one block per
staged tile) for any other C or alignment. Either route takes any C: a
layer wider than 64 channels runs as channel slices of at most 64 inside
its one launch (``dw_slices``).

The bfloat16 dense layer takes its weights as the image of
``pack_conv_weights`` (packed here once per call) and its input through TMA
tensor maps, which need 16-byte pixel strides: ``input_route`` is the rule,
by shape. A tensor whose channel count is a multiple of 8, or a list of up
to three tensors of equal width, a multiple of 16, is read in place (a
list without a concatenation); anything else (the head's 3 channels, the
flow head's 81) is first copied into one buffer zero-padded to a multiple
of 8 channels.

The float32 dense layer (``csrc/conv_f32.cuh``: an implicit GEMM of FP32
FMAs, no TF32) takes the model's float32 HWIO weights as they are and reads
its input in place on the route ``f32_input_route`` gives by shape: TMA
boxes where cin and every part's channels are multiples of 4 and the parts
16-byte aligned, 4-byte ``cp.async`` otherwise (the 3-channel heads); only
a list whose parts differ in width (or a non-contiguous part) is copied
into one buffer first. ``f32_plan`` is its launch plan (tile, N tile,
stages, resident weights), the same rule as the kernel's; counter
``conv_f32`` (beside the op's ``conv_chain``).

Under autograd the chain is a ``torch.autograd.Function`` (``_ConvChain``),
the port of ``conv_chain_fused``'s ``custom_vjp``: the forward is the
dispatch above (the kernels on the card), the backward the vjp of
``conv_chain_plain`` recomputed from the saved inputs and parameters, as
``_cc_bwd`` takes the vjp of ``_chain_xla``; a list input gets one gradient
per tensor. Where nothing needs a gradient the call is the serving one. The
plain version's relu is ``torch.maximum(y, 0)``, ``jnp.maximum``'s
gradient of ½ at a tie (``torch.relu`` gives 0 there).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from nerve_tpu_torch.ops import _build, dispatch

Entry = Tuple[torch.Tensor, torch.Tensor, str]
MAX_DW_SLICE = 64  # channels of one slice of csrc/dwconv3.cu (its MAX_C)
DW_ROUTES = {"tma": 0, "tile": 1}  # csrc/nerve_tpu_torch.h NT_DW_TMA, NT_DW_TILE
DW_LAUNCH_RECORD = ("grid", "threads", "dynamic_smem_bytes", "static_smem_bytes", "registers",
                    "spill_bytes", "tiles", "tile_h", "tile_w", "slices", "slice_channels")
N_TILES = (8, 16, 32, 64, 128)  # the bf16 kernel's output-channel tiles (wgmma N)
CHUNK = 16  # input channels per K step of the bf16 kernel
MAX_PARTS = 3  # input tensors the dense kernels read in place
# The float32 dense layer's plan, as csrc/conv_f32.cuh has it: by kernel
# size and cout, (largest cout, output channels a thread, warps across N,
# warps down M); input channels of a K chunk by kernel size; pixels a
# thread down a column; tile columns; ring stages; stages beside resident
# weights; bytes of the ring's barriers.
F32_CFG = {1: ((4, 4, 1, 4), (16, 8, 2, 2), (32, 8, 4, 1), (64, 16, 4, 2)),
           3: ((4, 4, 1, 4), (16, 8, 2, 2), (32, 8, 4, 1), (64, 8, 8, 1))}
F32_CHUNK = {1: 16, 3: 8}
F32_P, F32_TW, F32_MAX_STAGES, F32_MIN_RESIDENT_STAGES, F32_BAR_BYTES = 8, 32, 4, 3, 1024
F32_GROUP = {1: 16, 3: 4}  # channels of a staged group (one TMA box)
F32_SPLIT, F32_SPLIT_THREADS = 2, 128  # a small grid's warp sets over each K chunk
H100_SMEM, H100_SMS = 232448, 132  # shared memory a block may opt in to; SMs
F32_LAUNCH_RECORD = ("grid", "threads", "dynamic_smem_bytes", "static_smem_bytes", "registers",
                     "spill_bytes", "tiles", "tile_h", "tile_w", "n_tile", "chunk", "stages",
                     "resident", "route", "split", "staged_store")
F32_ROUTES = ("tma", "async")  # csrc/conv_f32.cuh F32_ROUTE_TMA, F32_ROUTE_ASYNC


def _layer_specs(params: Sequence[Entry]):
    """[(kind, cin, cout, act)] with validation; kind ∈ {3x3, 1x1, dw3}."""
    specs = []
    for w, _b, act in params:
        if w.ndim == 3:
            if tuple(w.shape[:2]) != (3, 3):
                raise ValueError("depthwise conv_chain layers must be 3x3")
            specs.append(("dw3", w.shape[2], w.shape[2], act))
        else:
            kh, kw, cin, cout = w.shape
            if (kh, kw) not in ((3, 3), (1, 1)):
                raise ValueError(f"conv_chain supports 3x3/1x1 kernels, got {kh}x{kw}")
            specs.append(("3x3" if kh == 3 else "1x1", cin, cout, act))
        if act not in ("relu", "none"):
            raise ValueError(f"unknown activation {act!r}")
    for a, b in zip(specs, specs[1:]):
        if a[2] != b[1]:
            raise ValueError("conv_chain layer channel mismatch")
    return specs


def _concat(x) -> torch.Tensor:
    if isinstance(x, (list, tuple)):
        return x[0] if len(x) == 1 else torch.cat(list(x), dim=-1)
    return x


def depthwise_sums(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A depthwise 3×3 layer's float32 sums on NCHW ``h`` with (3, 3, C)
    weights ``w`` (at ``h``'s dtype): from 0, taps dy outer, dx inner, SAME
    zero padding. A product of two bfloat16 values is exact in float32, so
    in bfloat16 each add is the ``fmaf`` of the reference's contract. The
    CPU's plain path takes it rather than ``F.conv2d(groups=C)``, whose
    bfloat16 form spreads an Inf into pixels outside its taps' reach."""
    _b, _c, hh, ww = h.shape
    acc_dt = torch.promote_types(h.dtype, torch.float32)
    xp = F.pad(h.to(acc_dt), (1, 1, 1, 1))
    wf = w.to(acc_dt)
    acc = torch.zeros(h.shape, dtype=acc_dt, device=h.device)
    for dy in range(3):
        for dx in range(3):
            acc = acc + xp[:, :, dy:dy + hh, dx:dx + ww] * wf[dy, dx][:, None, None]
    return acc


def conv_chain_plain(x, params: Sequence[Entry]) -> torch.Tensor:
    """Plain version: ``F.conv2d`` per layer on NCHW views, reference
    rounding. On the CPU, whose bfloat16 convolutions spread an Inf beyond
    their taps' reach, the same products are summed in float32 instead: the
    dense layers by ``F.conv2d`` on the values rounded to the dtype, the
    depthwise ones by ``depthwise_sums``."""
    x = _concat(x)
    _layer_specs(params)
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)  # float32, float64 for a float64 chain
    cpu = x.device.type == "cpu"
    h = x.permute(0, 3, 1, 2)
    for w, bias, act in params:
        if w.ndim == 3 and cpu:
            y = depthwise_sums(h, w.to(dt)).to(dt)
        elif w.ndim == 3:  # (3, 3, C) → (C, 1, 3, 3), groups = C
            y = F.conv2d(h, w.to(dt).permute(2, 0, 1).unsqueeze(1), padding=1, groups=w.shape[2])
        else:
            cdt = acc if cpu else dt
            wk = w.to(dt).to(cdt).permute(3, 2, 0, 1)
            y = F.conv2d(h.to(cdt), wk, padding=w.shape[0] // 2).to(dt)
        y = y.to(acc) + bias.to(acc)[:, None, None]
        if act == "relu":
            y = torch.maximum(y, y.new_zeros(()))
        h = y.to(dt)
    return h.permute(0, 2, 3, 1).contiguous()


def n_tile(cout: int) -> int:
    """The bf16 kernel's output-channel tile for a layer of ``cout`` channels."""
    return next((n for n in N_TILES if cout <= n), N_TILES[-1])


def pack_conv_weights(w: torch.Tensor, nt: int | None = None) -> torch.Tensor:
    """HWIO weights ``(k, k, cin, cout)`` → the bf16 kernel's image, 1-D bf16.

    The image is ``[n-tile][chunk][tap][k half][n / 8][n % 8][k % 8]``: for
    each N tile of ``nt`` (default ``n_tile(cout)``) output channels and each 16-channel
    input chunk, the k×k taps (row-major) of a 16 × N slice in wgmma's
    K-major core matrices (8 output channels × 8 input channels, 128
    bytes), the chunk's first 8 input channels before its last 8. Input
    channels past ``cin`` and output channels past ``cout`` are zero. The
    weights are rounded to bf16 as the reference rounds them to the input
    dtype.
    """
    k, _k, cin, cout = w.shape
    nt = nt or n_tile(cout)
    ncot, nch = -(-cout // nt), -(-cin // CHUNK)
    wp = w.new_zeros((k * k, nch * CHUNK, ncot * nt), dtype=torch.bfloat16)
    wp[:, :cin, :cout] = w.reshape(k * k, cin, cout).to(torch.bfloat16)
    # (tap, chunk, k half, k % 8, n-tile, n / 8, n % 8) → the image's order
    wp = wp.reshape(k * k, nch, 2, 8, ncot, nt // 8, 8).permute(4, 1, 0, 2, 5, 6, 3)
    return wp.contiguous().reshape(-1)


def input_route(xs: Sequence[torch.Tensor], cin: int) -> str:
    """How the bf16 kernel takes the input parts ``xs`` (NHWC, concatenated
    on channels) of a layer that reads their first ``cin`` channels.

    ``"tma"``: read in place, one tensor map per part. That takes one
    contiguous, 16-byte-aligned tensor whose channel count is a multiple of
    8 (its leading ``cin`` channels are read: TMA needs 16-byte pixel
    strides), or 2-3 such tensors of equal width, a multiple of 16 (each
    16-channel chunk from one tensor), whose channels together are ``cin``.
    ``"padded"``: anything else is first copied into one buffer of
    ``ceil8(cin)`` channels, zero beyond ``cin`` (``padded_input``). Raises
    on parts that differ in batch, height or width, or hold too few
    channels.
    """
    if any(t.ndim != 4 for t in xs) or len({tuple(t.shape[:3]) for t in xs}) != 1:
        raise ValueError(f"conv layer input parts {[tuple(t.shape) for t in xs]} are not "
                         "NHWC tensors of one size")
    widths = [t.shape[-1] for t in xs]
    if sum(widths) < cin or (len(xs) > 1 and sum(widths) != cin):
        raise ValueError(f"conv layer reads {cin} channels of input parts {widths}")
    in_place = all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in xs) and (
        widths[0] % 8 == 0 if len(xs) == 1
        else len(xs) <= MAX_PARTS and len(set(widths)) == 1 and widths[0] % 16 == 0)
    return "tma" if in_place else "padded"


def padded_input(xs: Sequence[torch.Tensor], cin: int) -> torch.Tensor:
    """Channels [0, cin) of the parts ``xs`` in one contiguous buffer of
    ``ceil8(cin)`` channels, zero beyond ``cin``: one copy."""
    pad = -cin % 8
    if len(xs) == 1:
        return F.pad(xs[0][..., :cin], (0, pad))
    return torch.cat([*xs, xs[0].new_zeros((*xs[0].shape[:3], pad))], dim=-1)


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def _round1024(n: int) -> int:
    return -(-n // 1024) * 1024


def f32_tiles(k: int, cfg: int, cout: int, b: int, h: int, w: int) -> int:
    """Tiles of a (b, h, w) output of ``cout`` channels in configuration
    ``cfg`` of a k×k layer."""
    _maxc, o, wn, wm = F32_CFG[k][cfg]
    return b * -(-h // (F32_P * wm)) * -(-w // F32_TW) * -(-cout // (o * wn))


def f32_plan(cin: int, cout: int, k: int, b: int = 1, h: int = 1080, w: int = 1920,
             smem: int = H100_SMEM, sms: int = H100_SMS) -> dict:
    """The float32 dense layer's launch plan for ``cin`` → ``cout`` channels
    of a k×k layer on a (b, h, w) frame, on a device of ``sms`` SMs whose
    blocks may use ``smem`` bytes of shared memory. ``csrc/conv_f32.cuh``
    ``f32_plan`` is the same rule:

    * the configuration (``F32_CFG`` by cout); a grid of fewer than two
      tiles an SM takes the next narrower one while that gives more tiles,
      and then, in a block of at most ``F32_SPLIT_THREADS`` threads,
      ``split``s each K chunk over ``F32_SPLIT`` warp sets whose sums meet
      in shared memory; its tile (``tile_h`` × ``tile_w`` pixels), N tile,
      threads and K chunk;
    * whether the weights stay resident in shared memory (one N tile,
      beside ``F32_MIN_RESIDENT_STAGES`` stages) or ride in each stage, and
      the ring's stages;
    * whether the output leaves through a staging area of one unit (8 rows
      × 32 pixels × at most 32 channels) and TMA stores, where that keeps
      the weights' residency and three stages;
    * the block's bytes: a block of at most ``F32_SPLIT_THREADS`` threads
      keeps to half the shared memory where that keeps the weights'
      residency (two blocks an SM).

    Raises where not even two stages fit."""
    if cin < 1 or cout < 1 or k not in (1, 3):
        raise ValueError(f"no float32 plan for {cin} -> {cout}, {k}x{k}")
    table = F32_CFG[k]
    cfg = next((i for i, c in enumerate(table) if cout <= c[0]), len(table) - 1)
    while (cfg > 0 and f32_tiles(k, cfg, cout, b, h, w) < 2 * sms
           and f32_tiles(k, cfg - 1, cout, b, h, w) > f32_tiles(k, cfg, cout, b, h, w)):
        cfg -= 1
    _maxc, o, wn, wm = table[cfg]
    nt, th, ck, tiles = o * wn, F32_P * wm, F32_CHUNK[k], f32_tiles(k, cfg, cout, b, h, w)
    base = 32 * wn * wm
    split = F32_SPLIT if tiles < 2 * sms and base <= F32_SPLIT_THREADS and cin > 4 else 1
    red = (split - 1) * base * F32_P * o * 4
    ih, iw, gc = th + k - 1, F32_TW + k - 1, F32_GROUP[k]
    in_bytes = ck // gc * _round128(ih * iw * gc * 4)
    ncot, ngroups = -(-cout // nt), -(-cin // gc)
    wbytes = _round1024(ngroups * gc * k * k * nt * 4)

    def fit(limit, out_bytes):
        avail = limit - F32_BAR_BYTES - red - (out_bytes + 1024 if out_bytes else 0)
        resident = ncot == 1 and wbytes + F32_MIN_RESIDENT_STAGES * in_bytes <= avail
        stage = _round1024(in_bytes + (0 if resident else _round128(ck * k * k * nt * 4)))
        stages = min(F32_MAX_STAGES, (avail - (wbytes if resident else 0)) // stage)
        used = F32_BAR_BYTES + (wbytes if resident else 0) + stages * stage + red
        if out_bytes:
            used = _round1024(used) + out_bytes
        return {"resident": resident, "stages": stages, "staged_store": bool(out_bytes),
                "smem_bytes": used}

    def best(limit):
        plain, staged = fit(limit, 0), fit(limit, F32_P * F32_TW * min(nt, 32) * 4)
        ok = staged["resident"] == plain["resident"] and staged["stages"] >= 3
        return staged if ok else plain

    fitted = best(smem)
    if base * split <= F32_SPLIT_THREADS:
        half = best(smem // 2 - 1024)
        if half["stages"] >= 2 and half["resident"] == fitted["resident"]:
            fitted = half
    if fitted["stages"] < 2:
        raise ValueError(f"the float32 layer {cin} -> {cout} does not fit {smem} bytes")
    return {"config": cfg, "tile_h": th, "tile_w": F32_TW, "n_tile": nt,
            "threads": base * split, "split": split, "out_channels_a_thread": o, "chunk": ck,
            "n_tiles": ncot, "tiles": tiles, "chunks": -(-ngroups * gc // ck), **fitted}


def f32_input_route(xs: Sequence[torch.Tensor], cin: int, k: int = 3) -> str:
    """How the float32 dense layer of kernel size ``k`` takes the input parts
    ``xs`` (NHWC, concatenated on channels) of a layer that reads their
    first ``cin`` channels.

    One contiguous tensor, or 2-3 contiguous tensors of equal width whose
    channels together are ``cin``, are read in place: ``"tma"`` (a 4-D TMA
    box a group of ``F32_GROUP[k]`` channels) where ``cin`` and the parts'
    width are multiples of 4 (16-byte pixel strides), every part is 16-byte
    aligned and, for a 1×1 layer on several parts, each part holds whole
    16-channel groups,
    ``"async"`` (4-byte ``cp.async``, any width and alignment: the
    3-channel heads) otherwise. ``"copy"``: parts of unequal widths, more
    than ``MAX_PARTS`` parts or a non-contiguous part are copied into one
    contiguous buffer first, which the kernel then reads on its own route.
    Raises on parts that differ in batch, height or width, or hold too few
    channels."""
    if any(t.ndim != 4 for t in xs) or len({tuple(t.shape[:3]) for t in xs}) != 1:
        raise ValueError(f"conv layer input parts {[tuple(t.shape) for t in xs]} are not "
                         "NHWC tensors of one size")
    widths = [t.shape[-1] for t in xs]
    if sum(widths) < cin or (len(xs) > 1 and sum(widths) != cin):
        raise ValueError(f"conv layer reads {cin} channels of input parts {widths}")
    if not all(t.is_contiguous() for t in xs) or len(xs) > MAX_PARTS or len(set(widths)) != 1:
        return "copy"
    tma = (cin % 4 == 0 and widths[0] % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in xs)
           and (k == 3 or len(xs) == 1 or widths[0] % F32_GROUP[1] == 0))
    return "tma" if tma else "async"


def f32_launch_record(x, cin: int, cout: int, k: int, lff: bool = False) -> dict:
    """What the float32 dense layer (or, ``lff``, the float32 RDB fusion: a
    1×1 layer over ``x``'s leading ``cin`` channels) launches on the input
    ``x`` (a CUDA tensor or a list of parts), without launching it: grid,
    threads, shared memory, registers, spills, tiles, the plan's tile, N
    tile, chunk, stages and resident weights, and the route."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    if not dispatch.use_kernel(*xs):
        raise ValueError("the launch record is the card's: pass CUDA tensors")
    route = f32_input_route(xs, cin, k)
    if route == "copy":
        xs = [torch.cat(xs, dim=-1).contiguous()]
    ptrs = [t.data_ptr() for t in xs] + [xs[0].data_ptr()] * (MAX_PARTS - len(xs))
    b, h, wd, xcs = xs[0].shape
    rec = (ctypes.c_int * len(F32_LAUNCH_RECORD))()
    _build.launch("nt_conv2d_f32_launch", xs[0].device, *ptrs, len(xs), xcs, cin, cout, b, h,
                  wd, k, int(lff), ctypes.addressof(rec))
    out = dict(zip(F32_LAUNCH_RECORD, rec))
    out["route"] = F32_ROUTES[out["route"]]
    return out


def conv_layer_launch(x, cin: int, w: torch.Tensor, bias: torch.Tensor,
                      out: torch.Tensor, out_coff: int, relu: bool) -> None:
    """Launch ``nt_conv2d``: channels [0, cin) of the input → channels
    [out_coff, out_coff + cout) of ``out`` (contiguous NHWC on CUDA). ``x``
    is a tensor or a list of parts concatenated on channels; ``w`` HWIO at
    any float dtype (rounded to the input dtype here: packed by
    ``pack_conv_weights`` for bfloat16), ``bias`` float32."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    k, _k, wcin, cout = w.shape
    if (wcin != cin or out_coff + cout > out.shape[-1] or tuple(bias.shape) != (cout,)):
        raise ValueError(f"conv layer {tuple(w.shape)}, bias {tuple(bias.shape)} does not "
                         f"fit output {tuple(out.shape)} at {out_coff}")
    dt = xs[0].dtype
    if out.shape[:3] != xs[0].shape[:3] or any(t.dtype != dt for t in (*xs, out)):
        raise ValueError("conv layer input and output differ in size or dtype")
    if not (out.is_contiguous() and bias.is_contiguous() and bias.dtype == torch.float32):
        raise ValueError("conv layer takes a contiguous output and a float32 bias")
    if dt == torch.bfloat16:
        if input_route(xs, cin) == "padded":
            xs = [padded_input(xs, cin)]
        wk = pack_conv_weights(w)
    elif dt == torch.float32:
        if f32_input_route(xs, cin, k) == "copy":
            xs = [torch.cat(xs, dim=-1).contiguous()]
        wk = w.float().contiguous()
    else:
        raise TypeError(f"the dense conv kernel takes float32 or bfloat16, got {dt}")
    ptrs = [t.data_ptr() for t in xs] + [xs[0].data_ptr()] * (MAX_PARTS - len(xs))
    b, h, wd, xcs = xs[0].shape
    _build.launch("nt_conv2d", out.device, *ptrs, len(xs), xcs, cin, wk.data_ptr(),
                  bias.data_ptr(), out.data_ptr(), out.shape[-1], out_coff, cout,
                  b, h, wd, k, int(relu), _build.dtype_code(out))
    if dt == torch.float32:
        dispatch.launches["conv_f32"] += 1


def dwconv3_route(shape: Sequence[int], dtype: torch.dtype, aligned: bool) -> str:
    """The depthwise kernel's route for an NHWC input of ``shape`` and
    ``dtype`` whose input and output both start on 16 bytes (``aligned``).

    ``"tma"``: a pixel is a multiple of 16 bytes (C a multiple of 8 in
    bfloat16, of 4 in float32; a TMA tensor map needs 16-byte strides) and
    the tensors are aligned. ``"tile"``: any other C or alignment. B, H
    and W do not matter."""
    c = shape[-1]
    return "tma" if aligned and c * dtype.itemsize % 16 == 0 else "tile"


def dw_slices(c: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(slices, channels a slice) of a depthwise layer of ``c`` channels:
    the fewest slices of at most ``MAX_DW_SLICE`` channels, each a multiple
    of a 16-byte vector's channels (8 in bfloat16, 4 in float32), the last
    one running past ``c`` where they do not divide it. ``c`` ≤ 64 is one
    slice of ``c`` channels rounded up to the vector. ``csrc/dwconv3.cu``
    ``slices_for`` is the same rule."""
    vec = 16 // dtype.itemsize
    n = -(-c // MAX_DW_SLICE)
    return n, -(-(-(-c // n)) // vec) * vec


def _dw_operands(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, out: torch.Tensor):
    """Check a depthwise layer's tensors; return ``w`` as the kernel takes it:
    float32 ``(3, 3, C)``, contiguous (the kernel rounds it to the input
    dtype). A weight of another dtype, or a non-contiguous one, is rounded to
    the input dtype here and widened (a no-op on the serving path)."""
    b, h, wd, c = x.shape
    if tuple(w.shape) != (3, 3, c) or tuple(bias.shape) != (c,) or out.shape != x.shape:
        raise ValueError(f"depthwise layer {tuple(w.shape)}, bias {tuple(bias.shape)} does "
                         f"not fit input {tuple(x.shape)} / output {tuple(out.shape)}")
    if c < 1:
        raise ValueError(f"a depthwise layer needs channels, got {c}")
    if not (x.is_contiguous() and out.is_contiguous() and bias.is_contiguous()
            and out.dtype == x.dtype and bias.dtype == torch.float32):
        raise ValueError("depthwise layer takes contiguous tensors and a float32 bias")
    if w.dtype != torch.float32 or not w.is_contiguous():
        w = w.to(x.dtype).float().contiguous()
    return w


def _dw_route(x: torch.Tensor, out: torch.Tensor) -> str:
    return dwconv3_route(x.shape, x.dtype, x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)


def dwconv3_launch(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   out: torch.Tensor, relu: bool) -> None:
    """Launch ``nt_dwconv3``: one depthwise 3×3 layer, ``x`` → ``out``, both
    contiguous (B, H, W, C) on CUDA, on the route ``dwconv3_route`` gives.
    ``w`` (3, 3, C), float32 as the model keeps it; ``bias`` float32 (C,)."""
    w = _dw_operands(x, w, bias, out)
    b, h, wd, c = x.shape
    _build.launch("nt_dwconv3", x.device, x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), c, b, h, wd, int(relu), DW_ROUTES[_dw_route(x, out)],
                  _build.dtype_code(x))


def dwconv3_launch_record(x: torch.Tensor) -> dict:
    """What a depthwise layer on ``x`` (contiguous NHWC on CUDA) launches,
    without launching it: the route, grid, threads, shared memory, the
    kernel's registers and spill bytes (``cudaFuncGetAttributes``), the
    number of tiles, the tile's height and width, and the channel slices
    and their width (``dw_slices``)."""
    if not dispatch.use_kernel(x):
        raise ValueError("the launch record is the card's: pass a CUDA tensor")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    b, h, wd, c = x.shape
    route = _dw_route(x, out)
    rec = (ctypes.c_int * len(DW_LAUNCH_RECORD))()
    _build.launch("nt_dwconv3_launch", x.device, x.data_ptr(), out.data_ptr(), c, b, h, wd,
                  DW_ROUTES[route], _build.dtype_code(x), ctypes.addressof(rec))
    return {"route": route, **dict(zip(DW_LAUNCH_RECORD, rec))}


class _ConvChain(torch.autograd.Function):
    """The chain on ``n_in`` input tensors, then its kernels, then biases:
    forward by dispatch, backward the vjp of ``conv_chain_plain``."""

    @staticmethod
    def forward(ctx, acts, n_in, *tensors):
        ctx.acts, ctx.n_in = acts, n_in
        ctx.save_for_backward(*tensors)
        params = _entries(tensors[n_in:], acts)
        return _chain_forward(list(tensors[:n_in]), params, _layer_specs(params))

    @staticmethod
    def backward(ctx, g):
        acts, n_in = ctx.acts, ctx.n_in
        grads = dispatch.recompute_vjp(
            lambda *t: conv_chain_plain(list(t[:n_in]), _entries(t[n_in:], acts)),
            ctx.saved_tensors, ctx.needs_input_grad[2:], g)
        return (None, None, *grads)


def _entries(wbs: Sequence[torch.Tensor], acts: Sequence[str]) -> list:
    """(kernels…, biases…) and acts → ``[(kernel, bias, act), …]``."""
    n = len(acts)
    return list(zip(wbs[:n], wbs[n:], acts))


def conv_chain_apply(x, params: Sequence[Entry]) -> torch.Tensor:
    """Run a conv(+relu) chain: (B, H, W, Cin) or a list → (B, H, W, Cout)."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    specs = _layer_specs(params)
    if any(t.dtype != xs[0].dtype for t in xs):
        raise ValueError("conv_chain inputs differ in dtype")
    if sum(t.shape[-1] for t in xs) != specs[0][1]:
        raise ValueError(f"conv_chain input has {sum(t.shape[-1] for t in xs)} channels, "
                         f"the first layer takes {specs[0][1]}")
    if dispatch.needs_grad(*xs, *(p for w, b, _ in params for p in (w, b))):
        return _ConvChain.apply(tuple(a for *_wb, a in params), len(xs), *xs,
                                *(w for w, _b, _a in params), *(b for _w, b, _a in params))
    return _chain_forward(xs, params, specs)


def _chain_forward(xs, params: Sequence[Entry], specs) -> torch.Tensor:
    if not dispatch.use_kernel(*xs, *(p for w, b, _ in params for p in (w, b))):
        return conv_chain_plain(xs, params)
    h = xs  # the first layer reads a list input in place
    for (w, bias, act), (kind, cin, cout, _act) in zip(params, specs):
        out = torch.empty((*xs[0].shape[:3], cout), dtype=xs[0].dtype, device=xs[0].device)
        bk = bias.float().contiguous()
        if kind == "dw3":
            dwconv3_launch(_concat(h).contiguous(), w, bk, out, act == "relu")
            dispatch.launches["conv_chain_dw3"] += 1
        else:
            conv_layer_launch(h, cin, w, bk, out, 0, act == "relu")
            dispatch.launches["conv_chain"] += 1
        h = out
    return h
