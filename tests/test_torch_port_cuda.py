"""The nerve_tpu_torch CUDA kernels against their plain versions, on the GPU.

Marked ``cuda``: each test skips where there is no CUDA device. The machine
with the GPU has no JAX, so this file imports none and runs without the
repository's conftest::

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Shapes are small and ragged (not multiples of the kernels' tiles). Limits,
relative to max|plain|: d2s bit-exact; float32 1e-4 (correlation 1e-5),
TF32 off; bfloat16 at the JAX package's kernel-gate levels (correlation
1e-2, conv chain 2.4e-2, also for its depthwise layers and the planar
chain, RDB 1.56e-2), since rounding to bfloat16 at
different sums can flip an intermediate by one unit in the last place.
The int8 kernels are held at the JAX package's kernel-vs-mirror levels: a
conv chain within 2 x its largest activation scale, an RDB block with
float32 output within 1e-4, a chain of blocks within 4 x its largest
scale (one int8 step of a requantised intermediate may flip); and
bit-exact: the int8 dense layer (``csrc/conv_int8.cu``) in all three tap
schedules, at ragged H, W and cin and at many tiles per block, the conv
chains through it, and the input quantisation (``csrc/quantize_i8.cu``).
The RDB fusions alone (``csrc/rdb.cu``, ``csrc/rdb_int8.cu``) from a wider
buffer into an offset slot, at many tiles per block, B = 2 and ragged W:
bf16 at the RDB's levels, int8 bit-exact in each output type, also on
values at .5 steps of the next scale; the bf16 stack through its two
buffers. The int8 slice's launches per frame are counted. The
RDB under the TPU kernels' rounding contracts (``ops.rdb_taps``) is held at
the RDB's levels and, in bfloat16, to a mean|Δ| against its contract's plain
version at most ¼ of that against any other contract's; the planar d2s
bit-exact.
"""

import importlib

import pytest
import torch

from nerve_tpu_torch import ops
from nerve_tpu_torch.diag import conv as diag_conv
from nerve_tpu_torch.diag import probe
from nerve_tpu_torch.models import quantize_sr, streaming_prime, streaming_step
from nerve_tpu_torch.ops import (
    conv_chain,
    conv_chain_int8,
    correlation,
    dispatch,
    planar_chain,
    rdb,
    rdb_int8,
    rdb_taps,
)

d2s = importlib.import_module("nerve_tpu_torch.ops.pixel_shuffle")

LIMITS = {  # kernel -> (float32, bfloat16) limits relative to max|plain|
    "correlation": (1e-5, 1e-2),
    "conv_chain": (1e-4, 2.4e-2),
    "rdb": (1e-4, 1.56e-2),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(g, *shape, std=1.0):
    return torch.randn(shape, generator=g) * std


def _conv_params(g, widths, kinds, dev):
    out = []
    for i, k in enumerate(kinds):
        cin, cout = widths[i], widths[i + 1]
        w = _rand(g, k, k, cin, cout, std=(k * k * cin) ** -0.5)
        act = "relu" if i < len(kinds) - 1 else "none"
        out.append((w.to(dev), _rand(g, cout, std=0.1).to(dev), act))
    return out


def _rdb_params(g, c, dev, layers=5, growth=32):
    params, cin = [], c
    for _ in range(layers):
        params += [_rand(g, 3, 3, cin, growth, std=(9 * cin) ** -0.5), _rand(g, growth, std=0.1)]
        cin += growth
    params += [_rand(g, cin, c, std=cin ** -0.5), _rand(g, c, std=0.1)]
    return [p.to(dev) for p in params]


def _check(kernel, got, ref, dt):
    lim = LIMITS[kernel][dt == torch.bfloat16]
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert err <= lim * scale, f"{kernel}: max|err| {err} > {lim} * {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_d2s_packed_bit_exact(cuda, dtype):
    g = torch.Generator().manual_seed(0)
    for shape, s in (((2, 13, 37, 12), 2), ((1, 5, 9, 27), 3)):
        x = _rand(g, *shape).to(cuda, dtype)
        n0 = dispatch.launches["d2s_packed"]
        got = ops.depth_to_space_packed(x, s)
        assert dispatch.launches["d2s_packed"] == n0 + 1
        assert torch.equal(got, d2s.depth_to_space_packed_plain(x, s))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2, 4])
def test_correlation(cuda, dtype, d):
    g = torch.Generator().manual_seed(1)
    f1, f2 = (_rand(g, 2, 11, 35, 16).to(cuda, dtype) for _ in range(2))
    _check("correlation", ops.correlation_volume(f1, f2, d),
           correlation.correlation_plain(f1, f2, d), dtype)


# name -> (input part widths, layer widths, kernel sizes): every output tile
# of the bf16 kernel (cout 2, 3, 12, 32, 64, 128), 1x1 and 3x3 layers, each
# input route (cin 3 and 81 padded, three 64-channel parts read in place,
# three 4-channel parts padded), the five flagship sites' widths.
CHAIN_GEOMETRIES = {
    "ragged_list": ([4, 4, 4], [12, 40, 20, 3, 12], [3, 1, 3, 3]),
    "head": ([3], [3, 64], [3]),
    "flow_head": ([81], [81, 128, 64, 32, 2], [3, 3, 3, 3]),
    "attention": ([64, 64, 64], [192, 64, 64, 3], [3, 3, 3]),
    "gff_upsampler": ([64], [64, 64, 12], [3, 3]),
    "pointwise": ([32], [32, 32, 128, 12], [1, 1, 1]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geometry", list(CHAIN_GEOMETRIES))
def test_conv_chain(cuda, dtype, geometry):
    """Dense chains on a ragged 2 x 13 x 37 frame, one launch per layer."""
    parts, widths, kinds = CHAIN_GEOMETRIES[geometry]
    g = torch.Generator().manual_seed(2)
    xs = [_rand(g, 2, 13, 37, c).to(cuda, dtype) for c in parts]
    params = _conv_params(g, widths, kinds, cuda)
    n0 = dispatch.launches["conv_chain"]
    got = ops.conv_chain_apply(xs, params)
    assert dispatch.launches["conv_chain"] == n0 + len(kinds)
    _check("conv_chain", got, conv_chain.conv_chain_plain(xs, params), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", ["resident", "streamed"])
def test_conv_chain_many_tiles(cuda, geometry):
    """A frame of several tiles for every block of the bf16 kernel, so that
    its ring of stages turns over many times: weights resident (64 -> 32)
    and streamed with the input (three 64-channel frames -> 64)."""
    g = torch.Generator().manual_seed(14)
    parts, widths = ([64], [64, 32]) if geometry == "resident" else ([64] * 3, [192, 64])
    xs = [_rand(g, 2, 136, 520, c).to(cuda, torch.bfloat16) for c in parts]
    params = _conv_params(g, widths, [3], cuda)
    _check("conv_chain", ops.conv_chain_apply(xs, params),
           conv_chain.conv_chain_plain(xs, params), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin", [64, 192])
def test_conv_layer_rdb_slot(cuda, dtype, cin):
    """The RDB form: the leading ``cin`` channels of a 224-channel buffer in,
    a 32-channel slot of the same buffer out, every other channel untouched."""
    g = torch.Generator().manual_seed(13)
    buf = _rand(g, 2, 13, 37, 224).to(cuda, dtype)
    (w, b, _act), = _conv_params(g, [cin, 32], [3], cuda)
    before = buf.clone()
    conv_chain.conv_layer_launch(buf, cin, w, b, buf, cin, relu=True)
    ref = conv_chain.conv_chain_plain(before[..., :cin], [(w, b, "relu")])
    _check("conv_chain", buf[..., cin:cin + 32], ref, dtype)
    assert torch.equal(buf[..., :cin], before[..., :cin])
    assert torch.equal(buf[..., cin + 32:], before[..., cin + 32:])


def _dw_params(g, c, act, dev):
    return (_rand(g, 3, 3, c, std=1 / 3).to(dev), _rand(g, c, std=0.1).to(dev), act)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [32, 64, 12])
def test_conv_chain_dw3(cuda, dtype, c):
    """Depthwise layers (ragged C=12 takes element loads) between dense ones."""
    g = torch.Generator().manual_seed(6)
    x = _rand(g, 2, 13, 37, c).to(cuda, dtype)
    params = [_dw_params(g, c, "relu", cuda), *_conv_params(g, [c, c], [1], cuda),
              _dw_params(g, c, "none", cuda)]
    n0 = dict(dispatch.launches)
    got = ops.conv_chain_apply(x, params)
    assert dispatch.launches["conv_chain_dw3"] == n0["conv_chain_dw3"] + 2
    assert dispatch.launches["conv_chain"] == n0["conv_chain"] + 1
    _check("conv_chain", got, conv_chain.conv_chain_plain(x, params), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chain", ["lightweight", "wide"])
def test_planar_chain(cuda, dtype, chain):
    """The lightweight body (3 -> 32, 4 x (dw3, 1x1), 32 -> 12) and a chain
    with a 64-wide layer, ragged widths and a depthwise last layer, in one
    launch each, on a frame that is not a multiple of the tile."""
    g = torch.Generator().manual_seed(7)
    if chain == "lightweight":
        params = _lightweight_body(g, cuda)
        x = torch.rand((2, 3, 21, 45), generator=g)
    else:
        params = _conv_params(g, [5, 64, 20], [3, 1], cuda) + [_dw_params(g, 20, "none", cuda)]
        x = _rand(g, 1, 5, 19, 70)
    x = x.to(cuda, dtype)
    n0 = dict(dispatch.launches)
    got = ops.planar_chain_apply(x, params)
    assert dispatch.launches["planar_chain"] == n0["planar_chain"] + 1
    assert dispatch.launches["conv_chain"] == n0["conv_chain"]
    _check("conv_chain", got, planar_chain.planar_chain_plain(x, params), dtype)


def _lightweight_body(g, dev):
    params = _conv_params(g, [3, 32], [3], dev)
    for _ in range(4):
        params += [_dw_params(g, 32, "none", dev), *_conv_params(g, [32, 32], [1], dev)]
        params[-1] = (*params[-1][:2], "relu")
    return params + _conv_params(g, [32, 12], [3], dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 3, 270, 480), (2, 3, 37, 101)])
def test_planar_chain_many_tiles(cuda, shape):
    """The lightweight body in bfloat16 over more output tiles than the
    card has persistent blocks (and a ragged frame): one launch per call;
    a pack made once and reused gives, to the bit, what a pack made in the
    call gives."""
    g = torch.Generator().manual_seed(13)
    params = _lightweight_body(g, cuda)
    x = torch.rand(shape, generator=g).to(cuda, torch.bfloat16)
    pk = planar_chain.packed_planar_chain(params, torch.bfloat16, cuda)
    n0 = dispatch.launches["planar_chain"]
    got = ops.planar_chain_apply(x, params, packed=pk)
    assert dispatch.launches["planar_chain"] == n0 + 1
    assert torch.equal(got, ops.planar_chain_apply(x, params))
    assert torch.equal(got, ops.planar_chain_apply(x, params, packed=pk))
    _check("conv_chain", got, planar_chain.planar_chain_plain(x, params), torch.bfloat16)


# name -> (layer widths, kinds: 3 / 1 dense, "dw" depthwise), each with a
# ragged frame: the folded head alone; a 1x1 first layer (the input box
# transposed) and a depthwise layer alone; 48- and 64-channel (depthwise,
# 1x1) pairs and a 1x1 last layer; two 64 -> 64 3x3 layers, whose bfloat16
# pack does not fit beside the persistent kernel's buffers (the per-tile
# kernel runs it).
PLANAR_GEOMETRIES = {
    "head_only": ([3, 12], [3]),
    "pointwise_first": ([6, 16, 16, 4], [1, "dw", 3]),
    "wide_pairs": ([3, 64, 64, 48, 48, 16, 8], [3, "dw", 1, "dw", 1, 1]),
    "wide_3x3_pair": ([64, 64, 64], [3, 3]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geometry", list(PLANAR_GEOMETRIES))
def test_planar_chain_geometry(cuda, dtype, geometry):
    _check_planar_geometry(cuda, dtype, *PLANAR_GEOMETRIES[geometry])


@pytest.mark.cuda
def test_planar_chain_wide_3x3_stack_bf16(cuda):
    """A folded 3 -> 64 head and three 64 -> 64 3x3 layers in bfloat16:
    ~255 KB of weights, more than fits beside the persistent kernel's
    buffers, so the per-tile kernel runs it (its folded head as FMAs).
    (In float32 one such layer's weights, 166 KB, leave no tile room.)"""
    _check_planar_geometry(cuda, torch.bfloat16, [3, 64, 64, 64, 64], [3, 3, 3, 3])


def _check_planar_geometry(cuda, dtype, widths, kinds):
    g = torch.Generator().manual_seed(14)
    params = []
    for i, k in enumerate(kinds):
        act = "relu" if i % 2 == 0 else "none"
        if k == "dw":
            params.append(_dw_params(g, widths[i], act, cuda))
        else:
            params += [(*e[:2], act) for e in _conv_params(g, widths[i:i + 2], [k], cuda)]
    x = _rand(g, 2, widths[0], 23, 77).to(cuda, dtype)
    n0 = dispatch.launches["planar_chain"]
    got = ops.planar_chain_apply(x, params)
    assert dispatch.launches["planar_chain"] == n0 + 1
    _check("conv_chain", got, planar_chain.planar_chain_plain(x, params), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_planar_chain_too_large_raises(cuda, dtype):
    """Sixteen 64-wide 3x3 layers: no tile of either kernel fits, so the
    call raises (and launches nothing)."""
    g = torch.Generator().manual_seed(15)
    params = _conv_params(g, [64] * 17, [3] * 16, cuda)
    x = _rand(g, 1, 64, 8, 16).to(cuda, dtype)
    n0 = dispatch.launches["planar_chain"]
    with pytest.raises(RuntimeError, match="nt_planar_chain"):
        ops.planar_chain_apply(x, params)
    assert dispatch.launches["planar_chain"] == n0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rdb(cuda, dtype):
    g = torch.Generator().manual_seed(3)
    plist = [[p.to(dtype) for p in _rdb_params(g, 16, cuda)] for _ in range(2)]
    x = _rand(g, 1, 10, 33, 16).to(cuda, dtype)
    _check("rdb", ops.rdb_chain_apply(x, plist), rdb.rdb_chain_plain(x, plist), dtype)


# name -> (batch, H, W, C, C + L·G): many tiles per block at a ragged width
# and B > 1, the card tests' C = 16 (176 is not a multiple of the 32- or
# 64-channel steps) and the flagship's C = 64.
LFF_SHAPES = {"c16": (2, 131, 517, 16, 176), "c64": (2, 131, 517, 64, 224)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(LFF_SHAPES))
def test_rdb_lff(cuda, shape, dtype):
    """The fusion alone: the leading C + L·G channels of a wider buffer in,
    an offset slot of a wider output out, against ``lff_plain`` at the RDB's
    levels; every other output channel untouched."""
    bsz, h, w, c, ccat = LFF_SHAPES[shape]
    g = torch.Generator().manual_seed(16)
    cat = _rand(g, bsz, h, w, ccat + 8).to(cuda, dtype)
    lw = _rand(g, ccat, c, std=ccat ** -0.5).to(cuda, dtype)
    lb = _rand(g, c, std=0.1).to(cuda)
    out = _rand(g, bsz, h, w, c + 24).to(cuda, dtype)
    before = out.clone()
    n0 = dispatch.launches["rdb_lff"]
    rdb.lff_launch(cat, lw, lb, out, 8)
    assert dispatch.launches["rdb_lff"] == n0 + 1
    _check("rdb", out[..., 8:8 + c], rdb.lff_plain(cat, lw, lb), dtype)
    assert torch.equal(out[..., :8], before[..., :8])
    assert torch.equal(out[..., 8 + c:], before[..., 8 + c:])


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", list(LFF_SHAPES))
def test_rdb_lff_i8_bit_exact(cuda, shape, out_dtype):
    """The int8 fusion alone, bit-exact against ``lff_plain_i8``: the
    leading C + L·G channels of a wider int8 buffer in, an offset slot of a
    wider output out. In channels [0, C / 2) the factors and biases are 0
    and s_in = s_next / 2, so v = x · s_in sits on .5 steps of s_next, where
    a reciprocal multiply would round some values otherwise."""
    bsz, h, w, c, ccat = LFF_SHAPES[shape]
    g = torch.Generator().manual_seed(17)
    cat = torch.randint(-127, 128, (bsz, h, w, -(-ccat // 16) * 16 + 16), generator=g,
                        dtype=torch.int8).to(cuda)
    wl = torch.randint(-127, 128, (ccat, c), generator=g, dtype=torch.int8)
    ldq, lbias = torch.rand(c, generator=g) * 1e-4, _rand(g, c, std=0.1)
    ldq[:c // 2], lbias[:c // 2] = 0.0, 0.0
    s_next = torch.tensor([0.3], device=cuda)
    s_in = s_next / 2
    image = conv_chain_int8.pack_i8_weights(wl, 1, c, c, rdb_int8.LFF_N_TILE).to(cuda)
    ldq, lbias, wl = ldq.to(cuda), lbias.to(cuda), wl.to(cuda)
    out = torch.zeros((bsz, h, w, c + 32), dtype=out_dtype, device=cuda)
    n0 = dispatch.launches["rdb_lff_i8"]
    rdb_int8.lff_launch_i8(cat, ccat, image, ldq, lbias, s_in, s_next, out, 16)
    assert dispatch.launches["rdb_lff_i8"] == n0 + 1
    ref = rdb_int8.lff_plain_i8(cat, wl, ldq, lbias, s_in[0], s_next[0], out_dtype)
    assert ref.dtype == out_dtype and torch.equal(out[..., 16:16 + c], ref)
    assert not out[..., :16].any() and not out[..., 16 + c:].any()
    if out_dtype == torch.int8:
        v = cat[..., :c // 2].float() * s_in[0]
        recip = torch.clamp(torch.round(v * (1 / s_next[0])), -127, 127).to(torch.int8)
        assert not torch.equal(ref[..., :c // 2], recip)  # the ties are there


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [12, 64])
def test_rdb_stack_two_buffers(cuda, dtype, c):
    """Three blocks through the two-buffer plan (C = 12: buffers of 176
    channels for 172), each block counted under ``rdb`` and ``rdb_lff``."""
    g = torch.Generator().manual_seed(18)
    plist = [[p.to(dtype) for p in _rdb_params(g, c, cuda)] for _ in range(3)]
    x = _rand(g, 2, 37, 133, c).to(cuda, dtype)
    n0 = dict(dispatch.launches)
    got = ops.rdb_chain_apply(x, plist)
    assert dispatch.launches["rdb"] == n0["rdb"] + 3
    assert dispatch.launches["rdb_lff"] == n0["rdb_lff"] + 3
    _check("rdb", got, rdb.rdb_chain_plain(x, plist), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", ["head", "list_1x1", "flow_like"])
def test_conv_chain_int8(cuda, out_dtype, site):
    g = torch.Generator().manual_seed(4)
    if site == "head":  # K=3: the input channels pad to 32 in shared memory
        xs, params = [_rand(g, 1, 13, 37, 3)], _conv_params(g, [3, 24], [3], cuda)
        params[-1] = (*params[-1][:2], "relu")
    elif site == "list_1x1":  # three frames, a 1x1 layer, a 12-channel end
        xs = [_rand(g, 2, 9, 35, 8) for _ in range(3)]
        params = _conv_params(g, [24, 40, 20, 12], [3, 1, 3], cuda)
    else:  # K=81 and a 2-channel end, as the flow head
        xs, params = [_rand(g, 2, 11, 17, 81)], _conv_params(g, [81, 48, 32, 2], [3, 3, 3], cuda)
    xs = [x.to(cuda, torch.bfloat16) for x in xs]
    scales = conv_chain_int8.calibrate_conv_chain(xs, params)
    qchain = conv_chain_int8.quantize_conv_chain(params, scales)
    cout = params[-1][0].shape[-1]
    n0 = dispatch.launches["conv_chain_int8"]
    got = ops.conv_chain_int8_apply(xs, qchain, cout, out_dtype=out_dtype)
    assert dispatch.launches["conv_chain_int8"] == n0 + len(params)
    ref = conv_chain_int8.conv_chain_int8_plain(xs, *qchain, cout, out_dtype)
    assert got.shape == ref.shape and got.dtype == ref.dtype == out_dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2 * scales.max().item(), f"max|err| {err}, scales {scales.tolist()}"


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [(16, 5, 32), (24, 3, 16)])
def test_rdb_int8(cuda, geometry):
    c, layers, growth = geometry
    g = torch.Generator().manual_seed(5)
    plist = [_rdb_params(g, c, cuda, layers, growth) for _ in range(3)]
    x = _rand(g, 1, 10, 33, c, std=0.5).to(cuda)
    scales = rdb_int8.calibrate_rdb_chain(x, plist)
    qchain = rdb_int8.quantize_rdb_chain(plist, scales)
    for blk in qchain:  # one block, float32 out: the whole arithmetic
        got = ops.rdb_chain_int8_apply(x, (blk,), out_dtype=torch.float32)
        ref = rdb_int8.rdb_chain_int8_plain(x, (blk,), torch.float32)
        assert (got - ref).abs().max().item() <= 1e-4
    n0 = dispatch.launches["rdb_int8"]
    got = ops.rdb_chain_int8_apply(x.bfloat16(), qchain)
    assert dispatch.launches["rdb_int8"] == n0 + len(qchain)
    ref = rdb_int8.rdb_chain_int8_plain(x.bfloat16(), qchain)
    assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == x.shape
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 4 * scales.max().item(), f"max|err| {err}, scales {scales.max().item()}"


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["int32_taps", "per_column_dx"])
def test_rdb_int8_schemes(cuda, scheme):
    """The per-channel int32-tap scheme and the per-column scheme with dx
    outer, bit-exact, each counted under its counters."""
    int32_taps, dx_major = scheme == "int32_taps", scheme == "per_column_dx"
    g = torch.Generator().manual_seed(8)
    plist = [_rdb_params(g, 16, cuda) for _ in range(2)]
    x = _rand(g, 1, 10, 33, 16, std=0.5).to(cuda)
    scales = rdb_int8.calibrate_rdb_chain(x, plist)
    qchain = rdb_int8.quantize_rdb_chain(plist, scales, per_channel=int32_taps)
    for blk in qchain:
        got = ops.rdb_chain_int8_apply(x, (blk,), torch.float32, int32_taps, dx_major)
        ref = rdb_int8.rdb_chain_int8_plain(x, (blk,), torch.float32, int32_taps, dx_major)
        assert torch.equal(got, ref)
    n0 = dict(dispatch.launches)
    got = ops.rdb_chain_int8_apply(x.bfloat16(), qchain, None, int32_taps, dx_major)
    assert dispatch.launches["rdb_int8"] == n0["rdb_int8"] + 2
    assert (dispatch.launches["rdb_int8_int32_taps"]
            == n0["rdb_int8_int32_taps"] + (2 if int32_taps else 0))
    ref = rdb_int8.rdb_chain_int8_plain(x.bfloat16(), qchain, None, int32_taps, dx_major)
    assert got.dtype == torch.bfloat16 and torch.equal(got, ref)


# name -> (batch, H, W, C, L, G): ragged H, W and cin (C + i G not a multiple
# of 32) at a few tiles per block; the flagship's widths over many tiles per
# block (the ping-pong rings turn over many times).
INT8_RDB_SHAPES = {
    "ragged": (2, 13, 37, 24, 3, 16),
    "many_tiles": (1, 136, 520, 64, 5, 32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["per_column", "per_column_dx", "int32_taps"])
@pytest.mark.parametrize("shape", list(INT8_RDB_SHAPES))
def test_rdb_int8_bit_exact(cuda, scheme, shape):
    """The int8 dense layer in each tap schedule: every block with float32
    output and the chain in bfloat16, bit-exact against the plain version."""
    bsz, h, w, c, layers, growth = INT8_RDB_SHAPES[shape]
    int32_taps, dx_major = scheme == "int32_taps", scheme == "per_column_dx"
    g = torch.Generator().manual_seed(15)
    plist = [_rdb_params(g, c, cuda, layers, growth) for _ in range(2)]
    x = _rand(g, bsz, h, w, c, std=0.5).to(cuda)
    scales = rdb_int8.calibrate_rdb_chain(x, plist)
    qchain = rdb_int8.quantize_rdb_chain(plist, scales, per_channel=int32_taps)
    for blk in qchain:
        got = ops.rdb_chain_int8_apply(x, (blk,), torch.float32, int32_taps, dx_major)
        ref = rdb_int8.rdb_chain_int8_plain(x, (blk,), torch.float32, int32_taps, dx_major)
        assert torch.equal(got, ref)
    n0 = dict(dispatch.launches)
    got = ops.rdb_chain_int8_apply(x.bfloat16(), qchain, None, int32_taps, dx_major)
    assert dispatch.launches["quantize_i8"] == n0["quantize_i8"] + 1
    ref = rdb_int8.rdb_chain_int8_plain(x.bfloat16(), qchain, None, int32_taps, dx_major)
    assert got.dtype == torch.bfloat16 and torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["head", "list_1x1", "flow_like", "wide_many_tiles"])
def test_conv_chain_int8_bit_exact(cuda, site):
    """int8 chains, bit-exact: a 3-channel frame, a ragged list with a 1x1
    layer, the flow head's widths (81 -> 128 walks four N tiles), and the
    attention site's 192 -> 64 -> 3 over many tiles per block."""
    g = torch.Generator().manual_seed(16)
    shape, parts, widths, kinds = {
        "head": ((1, 13, 37), [3], [3, 64], [3]),
        "list_1x1": ((2, 9, 35), [4, 4, 4], [12, 40, 20, 3, 12], [3, 1, 3, 3]),
        "flow_like": ((2, 11, 17), [81], [81, 128, 64, 32, 2], [3, 3, 3, 3]),
        "wide_many_tiles": ((1, 96, 333), [64, 64, 64], [192, 64, 3], [3, 3]),
    }[site]
    xs = [_rand(g, *shape, c).to(cuda, torch.bfloat16) for c in parts]
    params = _conv_params(g, widths, kinds, cuda)
    qchain = conv_chain_int8.quantize_conv_chain(
        params, conv_chain_int8.calibrate_conv_chain(xs, params))
    for out_dtype in (torch.float32, torch.bfloat16):
        n0 = dict(dispatch.launches)
        got = ops.conv_chain_int8_apply(xs, qchain, widths[-1], out_dtype=out_dtype)
        assert dispatch.launches["conv_chain_int8"] == n0["conv_chain_int8"] + len(kinds)
        assert dispatch.launches["quantize_i8"] == n0["quantize_i8"] + 1
        ref = conv_chain_int8.conv_chain_int8_plain(xs, *qchain, widths[-1], out_dtype)
        assert got.dtype == out_dtype and torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_i8_bit_exact(cuda, dtype):
    """Values at and next to (k + 0.5)·s for k of both parities and signs,
    some of which round otherwise under x · (1 / s) than under x / s,
    values past +-127, three ragged parts into their slots, pad channels
    zero, the rest untouched."""
    g = torch.Generator().manual_seed(17)
    s = torch.tensor(0.3, device=cuda)
    parts = []
    for c in (3, 16, 9):
        v = _rand(g, 2, 7, 11, c, std=60.0)
        ties = (torch.randint(-140, 140, v.shape, generator=g) + 0.5) * 0.3
        r = torch.rand(v.shape, generator=g)
        ties = torch.where(r < 0.2, ties, torch.nextafter(ties, torch.where(
            r < 0.35, torch.tensor(float("inf")), torch.tensor(float("-inf")))))
        v = torch.where(r < 0.5, ties, v)
        parts.append(v.to(cuda, dtype))
    x = torch.cat(parts, -1).float()
    assert bool((torch.round(x * (1 / s)) != torch.round(x / s)).any())
    out = torch.full((2, 7, 11, 48), 5, dtype=torch.int8, device=cuda)
    ref = conv_chain_int8.quantize_into_plain(parts, s, out.clone(), 32)
    n0 = dispatch.launches["quantize_i8"]
    conv_chain_int8.quantize_into(parts, s, out, 32)
    assert dispatch.launches["quantize_i8"] == n0 + 1
    assert torch.equal(out, ref)
    assert bool((out[..., 28:32] == 0).all() and (out[..., 32:] == 5).all())
    assert bool((out[..., :28].abs() == 127).any())


@pytest.mark.cuda
def test_int8_slice_launches(cuda):
    """The flagship's int8 configuration (64 features, 8 RDBs) on a small
    frame: per frame 10 conv_chain_int8, 8 rdb_int8 (each with its fusion,
    8 rdb_lff_i8) and 6 quantize_i8 launches (five chain sites and the RDB
    stack), no bf16 conv, RDB or fusion, and
    no weight packing once the first step has packed each int8 state. The
    model is built inside inference mode, as serving code may build it."""
    with torch.inference_mode():
        model = diag_conv.seeded_model(cuda, 0, quantized=True, quantized_chains=True)
    g = torch.Generator().manual_seed(18)
    video = [torch.rand((1, 32, 48, 3), generator=g).to(cuda) for _ in range(5)]
    quantize_sr(model, torch.stack(video[:3], dim=1), device=cuda)
    with torch.inference_mode():
        carry = streaming_prime(model, video[0])
        carry, _out = streaming_step(model, carry, video[1], "packed")
        dispatch.reset_launches()
        for frame in video[2:]:
            carry, out = streaming_step(model, carry, frame, "packed")
    torch.cuda.synchronize()
    n = len(video) - 2
    want = {"conv_chain_int8": 10 * n, "rdb_int8": 8 * n, "quantize_i8": 6 * n,
            "rdb_lff_i8": 8 * n, "conv_chain": 0, "rdb": 0, "rdb_lff": 0,
            "rdb_int8_int32_taps": 0}
    assert {k: dispatch.launches[k] for k in want} == want
    assert dispatch.packs["int8"] == 0
    assert out.shape == (1, 64, 96 * 3) and bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flow_warp_card_matches_cpu(cuda, dtype):
    """The warp is the same PyTorch on both devices, and the card gives the
    CPU's bits (which the CPU tests hold to JAX), flow leaving the frame
    included."""
    g = torch.Generator().manual_seed(19)
    feat = _rand(g, 2, 37, 53, 24).to(dtype)
    flow = _rand(g, 2, 37, 53, 2, std=5.0).to(dtype)
    got = ops.flow_warp(feat.to(cuda), flow.to(cuda))
    assert torch.equal(got.cpu(), ops.flow_warp(feat, flow))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", [*rdb_taps.CONTRACTS, "noshift", "nolff"])
def test_rdb_taps(cuda, dtype, mode):
    """Each rounding contract and ablation on a ragged frame; C=12 takes the
    element loads, C=64 the widest layers (cin 192 on a 16-wide slice)."""
    g = torch.Generator().manual_seed(9)
    for c, shape in ((12, (2, 13, 37)), (64, (1, 9, 35))):
        params = [p.to(dtype) for p in _rdb_params(g, c, cuda)]
        x = _rand(g, *shape, c).to(cuda, dtype)
        n0 = dispatch.launches["rdb_taps"]
        got = ops.rdb_taps_apply(x, params, mode)
        assert dispatch.launches["rdb_taps"] == n0 + 1
        _check("rdb", got, rdb_taps.rdb_taps_plain(x, params, mode), dtype)
        if dtype == torch.bfloat16 and mode in rdb_taps.CONTRACTS:
            mine, least_other = rdb_taps.contract_margin(got, x, params, mode)
            assert mine <= 0.25 * least_other, (mode, c, mine, least_other)


@pytest.mark.cuda
def test_rdb_taps_matonly_launches(cuda):
    g = torch.Generator().manual_seed(10)
    params = [p.bfloat16() for p in _rdb_params(g, 16, cuda)]
    x = _rand(g, 1, 10, 33, 16).to(cuda, torch.bfloat16)
    n0 = dispatch.launches["rdb_taps"]
    assert ops.rdb_taps_apply(x, params, "matonly").shape == x.shape
    torch.cuda.synchronize()
    assert dispatch.launches["rdb_taps"] == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_d2s_packed_planar_bit_exact(cuda, dtype):
    g = torch.Generator().manual_seed(11)
    for shape, s in (((2, 12, 13, 37), 2), ((1, 27, 5, 9), 3)):
        x = _rand(g, *shape).to(cuda, dtype)
        n0 = dispatch.launches["d2s_packed_planar"]
        got = ops.depth_to_space_packed_planar(x, s)
        assert dispatch.launches["d2s_packed_planar"] == n0 + 1
        assert torch.equal(got, d2s.depth_to_space_packed_planar_plain(x, s))
        assert torch.equal(got, d2s.depth_to_space_packed_plain(x.permute(0, 2, 3, 1), s))


@pytest.mark.cuda
def test_probe(cuda, capsys):
    n0 = dispatch.launches["probe"]
    assert probe.main([]) == 0
    assert dispatch.launches["probe"] == n0 + 1
    assert capsys.readouterr().out.strip() == "probe ok"
    a = _rand(torch.Generator().manual_seed(12), 8, 128).to(cuda)
    assert torch.equal(probe.probe_scale2(a), probe.probe_scale2_plain(a))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 1024, 4099])
def test_probe_sizes_and_offsets(cuda, n):
    """16-byte accesses with a scalar tail, and on a view at an odd offset
    (the scalar path): each equal to a * 2."""
    base = _rand(torch.Generator().manual_seed(15), n + 1).to(cuda)
    for a in (base[:n], base[1:]):
        n0 = dispatch.launches["probe"]
        got = probe.probe_scale2(a)
        assert dispatch.launches["probe"] == n0 + 1
        assert torch.equal(got, a * 2)
