"""The nerve_tpu_torch CUDA kernels against their plain versions, on the GPU.

Marked ``cuda``: each test skips where there is no CUDA device. The machine
with the GPU has no JAX, so this file imports none and runs without the
repository's conftest::

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Shapes are small and ragged (not multiples of the kernels' tiles). The
correlation runs d = 1..4 over many tiles, partial tiles on every edge,
padded channel counts, a non-contiguous and a misaligned input, one launch
a call, and is bit-exact on the exact-sum input, which a kernel that drops
the per-product bfloat16 rounding fails. Limits,
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
version at most ¼ of that against any other contract's, also over many
tiles at an odd shape and in a block whose widest layer reads 384
channels; the planar d2s bit-exact at odd widths and s = 2, 3, 4. The
depthwise layer runs wider than 64 channels (channel slices) on both
routes, and at 64 channels or fewer launches what it did before slices.
The planar chain keeps a non-finite input value where the plain version
does: the same values are NaN, +Inf and -Inf, the finite ones at the chain's
level, also behind padded channels where a relu turns an -Inf into 0, and
also where a finite input overflows bfloat16 inside the chain. The float32
dense layer and fusion (``csrc/conv_f32.cuh``) at the float32 level over
every input and output width of the paths, both kernel sizes, ragged
frames, batch 1 and 12, many tiles a block, both staging routes, channel
slots, list inputs of 2 and 3 parts; their launch records against the host
plan ``f32_plan``.
Training: each kernel op under autograd (the conv chain on a list of three
frames, the RDB stack, the correlation, the warp) against plain autograd
through its plain version, output and gradients at the levels above (the
warp, whose plain backward scatters in bfloat16, at the chain's), at a
small and at the training shape; a small
flagship's launches per train step and a bit-exact resume. Continual
learning: each op's second derivatives (``create_graph=True``) against
those through its plain version, at the small shapes and at the continual
experiment's widths, at the training levels. Federated learning: the
lightweight model's train step (live BatchNorm) and frozen-statistics step,
float32 at batch 8, LR 16² and 64², output, gradients and statistics against
the plain route at the conv chain's float32 level (each gradient within 10×
that, all together within it in relative L2), and the launches of a step.
The int8 configuration in training mode: its chain sites in float, its RDB
stack in int8 without a gradient. BatchNorm gradients of the flagship's
and the lightweight model's train steps against float64: the kernel
route's error within 2x of the plain route's. The recovery net's train
step on the card against the CPU. ABR and MLOps (plain PyTorch): the
batched streaming env, a PPO update and the MMD drift score on the card
against the CPU at ``diag.abr``'s limits. The multi-device paths
(``nerve_tpu_torch.parallel``; one card takes one NCCL rank): the sharded
flagship and the data-parallel step at NCCL world size 1 against one card,
and two gloo ranks sharing the card serving the lightweight model sharded.
"""

import importlib
import json
import math

import pytest
import torch

from nerve_tpu_torch import ops
from nerve_tpu_torch.diag import conv as diag_conv
from nerve_tpu_torch.diag import correlation as diag_corr
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


# Many tiles per block and partial 8 x 32 tiles on all four edges; C whose
# pixel stride is not a multiple of 16 bytes (3, 20: the padded route), two
# 128-byte channel chunks (128 in bfloat16; 64 and 128 in float32).
CORR_SHAPES = [(2, 37, 131, 64), (3, 9, 33, 16), (1, 5, 7, 64), (2, 19, 45, 3),
               (1, 11, 40, 20), (1, 13, 35, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_correlation(cuda, dtype, d):
    g = torch.Generator().manual_seed(1)
    cases = [tuple(_rand(g, *shape).to(cuda, dtype) for _ in range(2)) for shape in CORR_SHAPES]
    # Non-contiguous (a channel slice of a wider tensor), and contiguous at
    # an offset that is not 16-byte aligned.
    wide = _rand(g, 2, 17, 50, 80).to(cuda, dtype)
    cases.append((wide[..., 8:72], wide[..., 16:]))
    flat = _rand(g, 1 + 2 * 9 * 33 * 64).to(cuda, dtype)
    cases.append((flat[1:].view(2, 9, 33, 64), flat[:-1].view(2, 9, 33, 64)))
    for f1, f2 in cases:
        n0 = dispatch.launches["correlation"]
        got = ops.correlation_volume(f1, f2, d)
        assert dispatch.launches["correlation"] == n0 + 1
        _check("correlation", got, correlation.correlation_plain(f1, f2, d), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_correlation_exact_sum_bit_exact(cuda, d):
    """Constant fields whose bfloat16 sums are exact in any order
    (``diag.correlation.exact_sum_inputs``): the kernel equals the plain
    version bit for bit; a kernel that does not round each product to
    bfloat16 gives 496 · 2⁻²⁴ inside the frame instead of 2⁻²⁴."""
    f1, f2, inside = diag_corr.exact_sum_inputs(2, 19, 45, device=cuda)
    got = ops.correlation_volume(f1, f2, d)
    assert torch.equal(got, correlation.correlation_plain(f1, f2, d))
    assert bool(got[:, d:-d, d:-d].float().eq(inside).all())


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


# The depthwise layer's two routes (ops.conv_chain.dwconv3_route): C = 8,
# 16, 32, 64 take "tma" in both dtypes; 3, 12, 20 take "tile" in bfloat16
# (12 and 20 are 48- and 80-byte pixels in float32: "tma"). 97 x 261 leaves
# partial tiles on the bottom and right edges of every tile geometry.
DW_CHANNELS = [8, 16, 32, 64, 3, 12, 20]


def _dw_case(g, shape, c, act, dtype, dev):
    x = _rand(g, *shape, c).to(dev, dtype)
    return x, [_dw_params(g, c, act, dev)]


def _dw_check(x, layer, route):
    """One launch on ``route``, against the plain version at the gate;
    returns max|err|."""
    out = torch.empty_like(x)
    assert conv_chain._dw_route(x, out) == route
    n0 = dispatch.launches["conv_chain_dw3"]
    got = ops.conv_chain_apply(x, layer)
    assert dispatch.launches["conv_chain_dw3"] == n0 + 1
    ref = conv_chain.conv_chain_plain(x, layer)
    _check("conv_chain", got, ref, x.dtype)
    return (got.float() - ref.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["relu", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", DW_CHANNELS)
def test_dw3_routes(cuda, c, dtype, act):
    g = torch.Generator().manual_seed(30 + c)
    x, layer = _dw_case(g, (2, 97, 261), c, act, dtype, cuda)
    route = conv_chain.dwconv3_route(x.shape, dtype, True)
    assert route == ("tma" if c * x.element_size() % 16 == 0 else "tile")
    print(f"dw3 C={c} {dtype} {act} {route}: max|err| {_dw_check(x, layer, route):.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [8, 32, 64, 128])
def test_dw3_many_tiles_per_block(cuda, c, dtype):
    """A frame where every persistent block walks several tiles through both
    stages."""
    g = torch.Generator().manual_seed(40 + c)
    x, layer = _dw_case(g, (2, 961, 1027), c, "relu", dtype, cuda)
    rec = conv_chain.dwconv3_launch_record(x)
    assert rec["route"] == "tma" and rec["tiles"] >= 3 * rec["grid"], rec
    print(f"dw3 many tiles C={c} {dtype} {rec}: max|err| {_dw_check(x, layer, 'tma'):.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["tma", "tile"])
@pytest.mark.parametrize("c", [96, 128, 200])
def test_dw3_wide(cuda, c, route, dtype):
    """Wider than one 64-channel slice, in one launch: "tma" on an aligned
    input, "tile" on one 2 elements into its storage; 200 channels leave
    the last slice partly past C."""
    g = torch.Generator().manual_seed(80 + c)
    shape = (2, 41, 67, c)
    off = 0 if route == "tma" else 2
    x = _rand(g, math.prod(shape) + off).to(cuda, dtype)[off:].view(shape)
    layer = [_dw_params(g, c, "relu", cuda)]
    rec = conv_chain.dwconv3_launch_record(x)
    assert rec["route"] == route, rec
    assert (rec["slices"], rec["slice_channels"]) == conv_chain.dw_slices(c, dtype), rec
    assert rec["slices"] > 1 and rec["slice_channels"] <= 64, rec
    print(f"dw3 wide C={c} {route} {dtype} {rec}: max|err| {_dw_check(x, layer, route):.3e}")


@pytest.mark.cuda
def test_dw3_narrow_launch_unchanged(cuda):
    """C <= 64 is one slice of C and launches what the kernel launched before
    channel slices: at the serving shapes the records measured then (grid
    132 on an H100's 132 SMs), and at a ragged shape the earlier plan's
    threads, shared memory and tiles on both routes and dtypes."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for c, want in ((32, dict(threads=384, dynamic_smem_bytes=208920, tiles=2160, tile_h=30,
                              tile_w=32)),
                    (64, dict(threads=384, dynamic_smem_bytes=221208, tiles=4320, tile_h=30,
                              tile_w=16))):
        rec = conv_chain.dwconv3_launch_record(
            torch.zeros((1, 1080, 1920, c), dtype=torch.bfloat16, device=cuda))
        assert {k: rec[k] for k in want} == want and rec["grid"] == sms, rec
        assert (rec["slices"], rec["slice_channels"]) == (1, c), rec
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        vec = 16 // es
        for c in DW_CHANNELS:
            x = torch.zeros((2, 97, 261, c), dtype=dtype, device=cuda)
            rec = conv_chain.dwconv3_launch_record(x)
            if c * es % 16 == 0:
                cv = c * es // 16
                tw = max(8, 128 // cv)
                stage = 32 * (tw + 2) * cv * 16
                want = dict(route="tma", threads=cv * tw * 3,
                            dynamic_smem_bytes=min(3, (optin - 24) // stage) * stage + 24,
                            tiles=2 * -(-261 // tw) * -(-97 // 30), tile_h=30, tile_w=tw)
            else:
                cv = -(-c // vec)
                tiles = 2 * -(-261 // 32) * -(-97 // 16)
                want = dict(route="tile", grid=tiles, threads=256,
                            dynamic_smem_bytes=18 * 34 * cv * 16 + 10 * cv * vec * 4,
                            tiles=tiles, tile_h=16, tile_w=32)
            assert {k: rec[k] for k in want} == want, (c, dtype, rec)
            assert (rec["slices"], rec["slice_channels"]) == (1, cv * vec), (c, dtype, rec)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw3_unaligned_base(cuda, dtype):
    """An input 2 elements into its storage is off 16 bytes: "tile"."""
    g = torch.Generator().manual_seed(50)
    shape = (2, 37, 45, 32)
    base = _rand(g, math.prod(shape) + 2).to(cuda, dtype)
    x = base[2:].view(shape)
    print(f"dw3 unaligned {dtype}: max|err| "
          f"{_dw_check(x, [_dw_params(g, 32, 'relu', cuda)], 'tile'):.3e}")


@pytest.mark.cuda
def test_dw3_one_kernel_per_layer(cuda, tmp_path):
    """A depthwise layer is one kernel launch: no ATen op on its weights."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator().manual_seed(51)
    x = _rand(g, 1, 64, 96, 32).to(cuda, torch.bfloat16)
    layers = [_dw_params(g, 32, "relu", cuda), _dw_params(g, 32, "none", cuda)]
    ops.conv_chain_apply(x, layers)
    torch.cuda.synchronize()
    n0 = dispatch.launches["conv_chain_dw3"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ops.conv_chain_apply(x, layers)
        torch.cuda.synchronize()
    assert dispatch.launches["conv_chain_dw3"] == n0 + 2
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    kernels = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]
               if e.get("cat") == "kernel"]
    assert len(kernels) == 2 and all("dw3" in k for k in kernels), kernels


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


def _padded_relu_chain(g, dev):
    """A folded 3 -> 20 head + relu whose weights from channel 0 are all
    positive, a (depthwise 20, 1x1 20 -> 20 + relu) pair and a 3x3 20 -> 12
    tail: an -Inf in channel 0 makes every head channel around it -Inf,
    which the relu turns into 0, so the reference stays finite; the
    kernel's 12 padded head channels must not carry 0 * -Inf = NaN on."""
    w = _rand(g, 3, 3, 3, 20, std=27 ** -0.5)
    w[:, :, 0, :] = w[:, :, 0, :].abs()
    return [(w.to(dev), _rand(g, 20, std=0.1).to(dev), "relu"), _dw_params(g, 20, "none", dev),
            *_conv_params(g, [20, 20, 12], [1, 3], dev)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chain", ["lightweight", "wide", "padded_relu"])
def test_planar_chain_non_finite(cuda, dtype, chain):
    """One +Inf, one -Inf and one NaN in the input: the kernel's output is
    NaN, +Inf and -Inf exactly where the plain version's is (the plain
    version run on the CPU, whose convolutions are direct), and its finite
    values are at the chain's level. The wide chain (20-channel layers:
    padded channels; a depthwise layer last) shows a value kept to its
    channel directly; the lightweight body's relu after each pair turns
    -Inf into 0. The padded-relu chain (``_padded_relu_chain``) takes one
    -Inf, which a relu must zero: its output is finite everywhere."""
    g = torch.Generator().manual_seed(15)
    if chain == "lightweight":
        params = _lightweight_body(g, cuda)
        x = torch.rand((2, 3, 37, 101), generator=g)
    elif chain == "wide":
        params = _conv_params(g, [5, 64, 20], [3, 1], cuda) + [_dw_params(g, 20, "none", cuda)]
        x = _rand(g, 2, 5, 37, 101)
    else:
        params = _padded_relu_chain(g, cuda)
        x = torch.rand((2, 3, 37, 101), generator=g)
    if chain == "padded_relu":
        x[1, 0, 20, 60] = float("-inf")
    else:
        x[0, 0, 5, 7], x[0, 1, 20, 60], x[1, 2, 30, 90] = (float("inf"), float("-inf"),
                                                           float("nan"))
    x = x.to(cuda, dtype)
    got = ops.planar_chain_apply(x, params)
    ref = planar_chain.planar_chain_plain(
        x.cpu(), [(w.cpu(), b.cpu(), a) for w, b, a in params]).to(cuda)
    bad = ~torch.isfinite(ref)
    if chain == "padded_relu":
        assert not bad.any()
    else:
        assert 0 < int(bad.sum()) < bad.numel() // 4
    for kind in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(kind(got), kind(ref)), (kind.__name__,
                                                   int((kind(got) != kind(ref)).sum()))
    _check("conv_chain", torch.where(bad, 0, got), torch.where(bad, 0, ref), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [32, 20], ids=["lightweight", "ragged_widths"])
def test_planar_chain_overflow(cuda, c):
    """A finite input whose second layer's sums overflow bfloat16 at a few
    pixels (``diag.planar.overflow_case``: every weight positive, so the
    reference carries +Inf and no NaN), in the lightweight body's shape and
    at width 20 (padded channels): the kernel's NaN, +Inf and -Inf are where
    the plain version's are, and its finite values at the chain's level. A
    stage after the overflow that ran unchecked would spread NaN through
    its depthwise layer's diagonal blocks (0 * Inf)."""
    from nerve_tpu_torch.diag import planar as diag_planar

    x, params = diag_planar.overflow_case(c, cuda)
    assert bool(torch.isfinite(x).all())
    got = ops.planar_chain_apply(x, params)
    ref = planar_chain.planar_chain_plain(
        x.cpu(), [(w.cpu(), b.cpu(), a) for w, b, a in params]).to(cuda)
    bad = ~torch.isfinite(ref)
    assert 0 < int(bad.sum()) < bad.numel() // 4 and not torch.isnan(ref).any()
    for kind in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(kind(got), kind(ref)), (kind.__name__,
                                                   int((kind(got) != kind(ref)).sum()))
    _check("conv_chain", torch.where(bad, 0, got), torch.where(bad, 0, ref), torch.bfloat16)


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


# The float32 dense layer and fusion (``csrc/conv_f32.cuh``): every input
# and output width of the paths, both kernel sizes, relu on and off.
F32_CIN = (3, 12, 32, 64, 96, 160, 192)
F32_COUT = (2, 3, 12, 32, 64)


def _f32_layer(g, cin, cout, k, dev):
    w = _rand(g, k, k, cin, cout, std=(k * k * cin) ** -0.5).to(dev)
    return w, _rand(g, cout, std=0.1).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("cout", F32_COUT)
@pytest.mark.parametrize("cin", F32_CIN)
def test_conv_f32_widths(cuda, cin, cout, k):
    """One float32 layer on a ragged 2 x 37 x 53 frame against its plain
    version at the float32 level (TF32 off), relu on for odd cin + cout:
    one ``conv_f32`` launch, on the route its shape gives."""
    g = torch.Generator().manual_seed(cin * 100 + cout * 10 + k)
    x = _rand(g, 2, 37, 53, cin).to(cuda)
    w, b = _f32_layer(g, cin, cout, k, cuda)
    layer = [(w, b, "relu" if (cin + cout) % 2 else "none")]
    n0 = dispatch.launches["conv_f32"]
    got = ops.conv_chain_apply(x, layer)
    assert dispatch.launches["conv_f32"] == n0 + 1
    assert conv_chain.f32_launch_record(x, cin, cout, k)["route"] == (
        "tma" if cin % 4 == 0 else "async")
    _check("conv_chain", got, conv_chain.conv_chain_plain(x, layer), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(12, 97, 261), (1, 97, 261), (12, 37, 53)])
@pytest.mark.parametrize("route", ["tma", "async"])
def test_conv_f32_many_tiles(cuda, shape, route):
    """64 -> 64 3x3 at batch 12 and 1 over many tiles for every persistent
    block (the ring turns over across tiles), on both staging routes: the
    cp.async route by an input one float into its storage."""
    g = torch.Generator().manual_seed(31)
    off = 0 if route == "tma" else 1
    n = math.prod(shape) * 64
    x = _rand(g, n + off).to(cuda)[off:].view(*shape, 64)
    w, b = _f32_layer(g, 64, 64, 3, cuda)
    rec = conv_chain.f32_launch_record(x, 64, 64, 3)
    assert rec["route"] == route and rec["tiles"] >= rec["grid"]
    if shape[0] == 12 and shape[1] == 97:
        assert rec["tiles"] > 4 * rec["grid"]
    layer = [(w, b, "relu")]
    _check("conv_chain", ops.conv_chain_apply(x, layer), conv_chain.conv_chain_plain(x, layer),
           torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("ocoff", [3, 8])
@pytest.mark.parametrize("k", [1, 3])
def test_conv_f32_slot(cuda, k, ocoff):
    """A 32-channel slot of a 77-channel output (16-byte stores at offset 8,
    element stores at 3), every other channel untouched."""
    g = torch.Generator().manual_seed(32)
    x = _rand(g, 2, 37, 53, 64).to(cuda)
    w, b = _f32_layer(g, 64, 32, k, cuda)
    out = _rand(g, 2, 37, 53, 77).to(cuda)
    before = out.clone()
    conv_chain.conv_layer_launch(x, 64, w, b, out, ocoff, relu=True)
    ref = conv_chain.conv_chain_plain(x, [(w, b, "relu")])
    _check("conv_chain", out[..., ocoff:ocoff + 32], ref, torch.float32)
    assert torch.equal(out[..., :ocoff], before[..., :ocoff])
    assert torch.equal(out[..., ocoff + 32:], before[..., ocoff + 32:])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 1])
@pytest.mark.parametrize("parts", [(32, 32), (64, 64, 64), (3, 3), (12, 12, 12), (4, 8)])
def test_conv_f32_list_parts(cuda, parts, k):
    """A list input of 2 and 3 parts read in place (TMA: widths a multiple
    of 4, of 16 for a 1x1 layer's 16-channel boxes; cp.async otherwise),
    parts of unequal widths copied first (``f32_input_route`` says "copy"),
    against the plain version."""
    g = torch.Generator().manual_seed(33)
    xs = [_rand(g, 2, 37, 53, c).to(cuda) for c in parts]
    cin = sum(parts)
    w, b = _f32_layer(g, cin, 32, k, cuda)
    route = conv_chain.f32_input_route(xs, cin, k)
    boxes = parts[0] % (4 if k == 3 else 16) == 0
    assert route == ("copy" if len(set(parts)) > 1 else "tma" if boxes else "async")
    assert conv_chain.f32_launch_record(xs, cin, 32, k)["route"] == (
        "tma" if route == "tma" or (route == "copy" and cin % 4 == 0) else "async")
    layer = [(w, b, "relu")]
    n0 = dispatch.launches["conv_f32"]
    got = ops.conv_chain_apply(xs, layer)
    assert dispatch.launches["conv_f32"] == n0 + 1
    _check("conv_chain", got, conv_chain.conv_chain_plain(xs, layer), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("ccat", [96, 224])
def test_rdb_lff_f32(cuda, ccat, c):
    """The float32 fusion alone over many tiles per block (2 x 131 x 517):
    the leading ccat channels of a wider buffer in, an offset slot of a
    wider output out, against ``lff_plain`` at the float32 level; one
    ``rdb_lff_f32`` launch; every other output channel untouched."""
    g = torch.Generator().manual_seed(34)
    cat = _rand(g, 2, 131, 517, ccat + 8).to(cuda)
    lw = _rand(g, ccat, c, std=ccat ** -0.5).to(cuda)
    lb = _rand(g, c, std=0.1).to(cuda)
    out = _rand(g, 2, 131, 517, c + 24).to(cuda)
    before = out.clone()
    n0 = dispatch.launches["rdb_lff_f32"]
    rdb.lff_launch(cat, lw, lb, out, 8)
    assert dispatch.launches["rdb_lff_f32"] == n0 + 1
    _check("rdb", out[..., 8:8 + c], rdb.lff_plain(cat, lw, lb), torch.float32)
    assert torch.equal(out[..., :8], before[..., :8])
    assert torch.equal(out[..., 8 + c:], before[..., 8 + c:])


@pytest.mark.cuda
def test_conv_f32_one_kernel_per_layer(cuda, tmp_path):
    """A float32 chain (3 -> 64 -> 64 -> 12 -> 2) is one kernel launch a
    layer and no other kernel (no ATen op on the weights or inputs); a
    float32 RDB block one a dense layer and one for its fusion; each launch record
    is the host plan ``f32_plan`` at the card's shared memory, with no
    spills and at most 255 registers."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator().manual_seed(35)
    x = _rand(g, 2, 64, 96, 3).to(cuda)
    params = _conv_params(g, [3, 64, 64, 12, 2], [3, 3, 1, 3], cuda)
    plist = [_rdb_params(g, 64, cuda)]
    xr = _rand(g, 1, 40, 72, 64).to(cuda)
    ops.conv_chain_apply(x, params)
    torch.cuda.synchronize()
    n0 = dict(dispatch.launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ops.conv_chain_apply(x, params)
        torch.cuda.synchronize()
    assert dispatch.launches["conv_f32"] == n0["conv_f32"] + 4
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    kernels = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]
               if e.get("cat") == "kernel"]
    assert len(kernels) == 4 and all("conv_f32_kernel" in k for k in kernels), kernels
    ops.rdb_chain_apply(xr, plist)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ops.rdb_chain_apply(xr, plist)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    kernels = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]
               if e.get("cat") == "kernel"]
    assert sum("conv_f32_kernel" in k for k in kernels) == 5, kernels
    assert sum("lff_f32_kernel" in k for k in kernels) == 1, kernels
    props = torch.cuda.get_device_properties(cuda)
    smem, sms = props.shared_memory_per_block_optin, props.multi_processor_count
    big = _rand(g, 2, 270, 480, 232).to(cuda)
    for xin, cin, cout, k, lff in [(x, 3, 64, 3, False), (xr, 64, 64, 3, False),
                                   (xr, 64, 12, 3, False), (xr, 64, 2, 1, False),
                                   (big, 64, 64, 3, False), (big, 192, 32, 3, False),
                                   (big, 224, 64, 1, True), (xr, 64, 64, 1, True)]:
        rec = conv_chain.f32_launch_record(xin, cin, cout, k, lff=lff)
        plan = conv_chain.f32_plan(cin, cout, k, *xin.shape[:3], smem=smem, sms=sms)
        assert rec["tiles"] == plan["tiles"], (rec, plan)
        assert rec["spill_bytes"] == 0 and 0 < rec["registers"] <= 255, rec
        assert rec["dynamic_smem_bytes"] == plan["smem_bytes"], (rec, plan)
        for key in ("tile_h", "tile_w", "n_tile", "threads", "chunk", "stages", "split"):
            assert rec[key] == plan[key], (key, rec, plan)
        assert bool(rec["resident"]) == plan["resident"], (rec, plan)
        assert bool(rec["staged_store"]) == plan["staged_store"], (rec, plan)
        print(f"conv_f32 {cin} -> {cout} {k}x{k}{' lff' if lff else ''}: {json.dumps(rec)}")


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
    """Each rounding contract and ablation on a ragged frame: C = 12 (cin
    not a multiple of the 16-channel chunk), C = 64 (cin up to 192, the
    weights resident), C = 64 over many tiles at an odd shape (the
    ping-pong rings turn over many times), and C = 128 with growth 64 (cin
    up to 384, two N tiles, the weights streamed with each chunk)."""
    g = torch.Generator().manual_seed(9)
    for c, shape, growth in ((12, (2, 13, 37), 32), (64, (1, 9, 35), 32),
                             (64, (1, 131, 517), 32), (128, (1, 19, 70), 64)):
        params = [p.to(dtype) for p in _rdb_params(g, c, cuda, growth=growth)]
        x = _rand(g, *shape, c).to(cuda, dtype)
        n0 = dispatch.launches["rdb_taps"]
        got = ops.rdb_taps_apply(x, params, mode)
        assert dispatch.launches["rdb_taps"] == n0 + 1
        _check("rdb", got, rdb_taps.rdb_taps_plain(x, params, mode), dtype)
        if dtype == torch.bfloat16 and mode in rdb_taps.CONTRACTS:
            mine, least_other = rdb_taps.contract_margin(got, x, params, mode)
            assert mine <= 0.25 * least_other, (mode, c, mine, least_other)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(rdb_taps.CONTRACTS))
def test_rdb_taps_launch_record(cuda, mode):
    """The bf16 layer's launch: one 384-thread block per SM, its contract's
    accumulator sets, weights resident at cin 192 (N tile 32) and streamed
    at cin 384 with two N tiles."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x = torch.zeros((1, 1080, 1920, 64), dtype=torch.bfloat16, device=cuda)
    sets = len(rdb_taps.accumulator_plan(mode)[1])
    rec = rdb_taps.launch_record(x, 192, 32, mode)
    print(f"rdb_taps {mode} cin 192: {rec}")
    assert rec["grid"] == sms and rec["threads"] == 384 and rec["tiles"] == 1080 * 30, rec
    assert (rec["n_tile"], rec["resident_weights"], rec["accumulator_sets"]) == (32, 1, sets), rec
    assert rec["stages"] >= 2, rec
    rec = rdb_taps.launch_record(x, 384, 64, mode)
    print(f"rdb_taps {mode} cin 384: {rec}")
    assert (rec["n_tile"], rec["resident_weights"], rec["tiles"]) == (32, 0, 2 * 1080 * 30), rec


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
@pytest.mark.parametrize("c", [1, 3, 4, 8])
@pytest.mark.parametrize("s", [2, 3, 4])
def test_d2s_packed_scales(cuda, s, c, dtype):
    """B = 2; W = 37 gives input rows that are not a multiple of 16 bytes
    (element loads) wherever C * s * s * W * size is not, W = 64 rows that
    are (bulk copies)."""
    g = torch.Generator().manual_seed(60 + 10 * s + c)
    for w in (37, 64):
        x = _rand(g, 2, 5, w, c * s * s).to(cuda, dtype)
        rec = d2s.launch_record(x, s)
        assert rec["bulk_copy"] == (w * c * s * s * x.element_size() % 16 == 0), rec
        n0 = dispatch.launches["d2s_packed"]
        got = ops.depth_to_space_packed(x, s)
        assert dispatch.launches["d2s_packed"] == n0 + 1
        assert torch.equal(got, d2s.depth_to_space_packed_plain(x, s)), (w, rec)


D2S_CASES = {  # name -> (shape, scale, storage offset in elements, record key, value)
    "serving": ((1, 1080, 1920, 12), 2, 0, "bulk_copy", 1),
    "unaligned": ((2, 9, 40, 12), 2, 1, "bulk_copy", 0),
    "long_rows": ((2, 3, 2500, 4), 2, 0, "segments", 2 * 3 * 2),  # 2 segments a row
    "per_element_offsets": ((2, 3, 9, 67 * 16), 4, 0, "fixed_offsets", 0),  # s * pv > the block
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(D2S_CASES))
def test_d2s_packed_layouts(cuda, case, dtype):
    shape, s, off, key, want = D2S_CASES[case]
    g = torch.Generator().manual_seed(70)
    x = _rand(g, math.prod(shape) + off).to(cuda, dtype)[off:].view(shape)
    rec = d2s.launch_record(x, s)
    assert rec[key] >= want if key == "segments" else rec[key] == want, rec
    n0 = dispatch.launches["d2s_packed"]
    got = ops.depth_to_space_packed(x, s)
    assert dispatch.launches["d2s_packed"] == n0 + 1
    assert torch.equal(got, d2s.depth_to_space_packed_plain(x, s)), rec


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_d2s_packed_planar_bit_exact(cuda, dtype):
    """Odd widths (element loads) at s = 2, 3, 4; widths of whole 16-byte
    runs (bulk copies); rows of several segments; the serving shape."""
    g = torch.Generator().manual_seed(11)
    for shape, s in (((2, 12, 13, 37), 2), ((1, 27, 5, 9), 3), ((2, 18, 7, 41), 3),
                     ((1, 32, 6, 33), 4), ((2, 48, 3, 101), 4), ((2, 12, 5, 64), 2),
                     ((1, 36, 4, 1536), 3), ((1, 12, 1080, 1920), 2)):
        x = _rand(g, *shape).to(cuda, dtype)
        rec = d2s.planar_launch_record(x, s)
        assert rec["bulk_copy"] == (shape[-1] * x.element_size() % 16 == 0), (shape, rec)
        plan = d2s.planar_segments(shape[-1], shape[1] // (s * s), s, dtype)
        assert rec["segment_pixels"] == plan["segment_pixels"], (shape, rec, plan)
        assert rec["segments"] == shape[0] * shape[2] * plan["segments"], (shape, rec, plan)
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


@pytest.mark.cuda
def test_engine_small_matches_plain(cuda):
    """The facade's engine (recovery base 8; SR 16 features, 2 RDBs, flow at
    half resolution) in bfloat16 on a 64 x 96 uint8 window with a mask:
    the card's outputs against the same engine on the CPU, whose ops are
    the plain versions, at the bf16 slice's limits; ``recovered`` the input
    outside the mask; 2 ``rdb`` and 2 ``rdb_lff`` launches."""
    # Imported here: the rest of this file also runs against checkouts that
    # predate the engine (the planar chain's repair, parent against change).
    from nerve_tpu_torch.models import EngineConfig, api

    cfg = EngineConfig(recovery_base_channels=8, sr_num_features=16, sr_num_residual_blocks=2,
                       sr_flow_downsample=2)
    eng = api.EnhancementEngine(cfg, seed=0, dtype=torch.bfloat16, device=cuda)
    diag_conv.seed_all(eng.module, 0)
    cpu = api.EnhancementEngine(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    cpu.module.load_state_dict(eng.module.state_dict())
    g = torch.Generator().manual_seed(24)
    video = torch.randint(0, 256, (1, 5, 3, 64, 96), generator=g, dtype=torch.uint8)
    mask = torch.zeros((1, 1, 64, 96))
    mask[..., 20:40, 30:70] = 1
    n0 = dict(dispatch.launches)
    got = eng(video, corruption_mask=mask)
    assert dispatch.launches["rdb"] - n0["rdb"] == 2
    assert dispatch.launches["rdb_lff"] - n0["rdb_lff"] == 2
    ref = cpu(video, corruption_mask=mask)
    for k in ("recovered", "super_resolved", "enhanced"):
        d = (got[k].cpu().float() - ref[k].float()).abs()
        assert d.max() <= 2e-2 and d.mean() <= 5e-4, (k, d.max().item(), d.mean().item())
    outside = mask[0, 0] == 0
    centre = video[0, 2].float() / 255
    assert torch.equal(got["recovered"][0].cpu()[:, outside], centre[:, outside])
    # uint8 frames divide by 255 on the card as on the CPU, bit for bit.
    every = torch.arange(256, dtype=torch.uint8)
    assert torch.equal(api.from_uint8(every.to(cuda)).cpu(), every.float() / 255)


# Training: each kernel op under autograd (the kernels forward, the vjp of
# the plain version backward) against plain autograd through its plain
# version; limits (float32, bfloat16) relative to max|plain|, chip_smoke.py's.
TRAIN_LIMITS = {"conv_chain": (1e-4, 2.4e-2), "rdb": (1e-4, 1.56e-2),
                "correlation": (1e-5, 1e-2), "warp": (1e-5, 2.4e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("small", [True, False], ids=["small", "training_shape"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(TRAIN_LIMITS))
def test_train_grads(cuda, name, dtype, small):
    """The attention chain on three frames, an RDB stack (4 blocks small, 8
    at the training shape), the correlation (d = 4) and the warp, at a
    ragged 2 × 13 × 17 × 16 and at batch 16, 64 × 64 × 64 (``diag.train``):
    output and every gradient; the kernel route launches its kernels, the
    backward none."""
    from nerve_tpu_torch.diag import train as diag_train

    kernel, plain, leaves, g = diag_train.grad_cases(cuda, dtype, small)[name]
    dispatch.reset_launches()
    out = kernel(*leaves)
    forward = dict(dispatch.launches)
    grads = torch.autograd.grad(out, leaves, g)
    assert dispatch.launches == forward  # the backward recomputes the plain version
    if name != "warp":
        assert sum(forward.values()) > 0
    ref = plain(*leaves)
    ref_grads = torch.autograd.grad(ref, leaves, g)
    limit = TRAIN_LIMITS[name][dtype == torch.bfloat16]
    for got, want in [(out, ref), *zip(grads, ref_grads)]:
        d = (got.float() - want.float()).abs().max().item()
        assert d <= limit * want.float().abs().max().item(), (name, d)


@pytest.mark.cuda
def test_train_step_launches_and_resume(cuda, tmp_path):
    """A small flagship (16 features, 2 RDBs) in bfloat16, batch 2 at 16 ×
    16: each step's forward launches 5 chains' layers (10), 2 ``rdb``, 2
    ``rdb_lff`` and a ``correlation``; a restored trainer's next loss equals
    the uninterrupted run's."""
    from nerve_tpu_torch.diag import train as diag_train
    from nerve_tpu_torch.utils.checkpoint import CheckpointManager

    model = diag_train.train_model(cuda, 0, features=16, blocks=2)
    batches = diag_train.train_batches(cuda, 3, lr_size=16, batch=2)
    state, step = diag_train.step_fn(model, steps=3)
    for batch in batches[:2]:
        dispatch.reset_launches()
        step(state, *batch)
        assert {k: v for k, v in dispatch.launches.items() if v} == {
            "conv_chain": 10, "rdb": 2, "rdb_lff": 2, "correlation": 1}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state.step, state.state_dict())
    loss = step(state, *batches[2])[1]["loss"]
    fresh, fstep = diag_train.step_fn(diag_train.train_model(cuda, 5, features=16, blocks=2),
                                      steps=3)
    fresh.load_state_dict(mgr.restore(fresh.state_dict()))
    assert torch.equal(fstep(fresh, *batches[2])[1]["loss"], loss)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [None, (4, 32, 32, 16, 2, 32)], ids=["small", "continual"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(TRAIN_LIMITS))
def test_double_backward(cuda, name, dtype, dims):
    """Second derivatives (``create_graph=True``) through each kernel op as
    the model calls it against those through its plain version
    (``diag.continual.compare_hvp``), at the small shapes and at the
    continual experiment's widths (16 features, RDB growth 32): every one
    the plain version has is there, nonzero, within ``TRAIN_LIMITS``; the
    forward launches the kernels."""
    from nerve_tpu_torch.diag import continual as diag_continual
    from nerve_tpu_torch.diag import train as diag_train

    kernel, plain, leaves, g = diag_train.grad_cases(cuda, dtype, small=dims is None,
                                                     dims=dims)[name]
    dispatch.reset_launches()
    stats = diag_continual.compare_hvp(kernel, plain, leaves, g)
    if name != "warp":
        assert sum(dispatch.launches.values()) > 0
    limit = TRAIN_LIMITS[name][dtype == torch.bfloat16]
    for i, st in enumerate(stats):
        assert not st["mismatch"], (name, i)
        assert st["max_abs"] <= limit * st["scale"], (name, i, st)


# The lightweight model's local steps of the federated path: launches per
# step (forward only; the backward recomputes the plain versions).
FED_STEP_LAUNCHES = {"train": {"conv_chain": 2, "conv_f32": 2},
                     "frozen_stats": {"conv_chain": 6, "conv_f32": 6, "conv_chain_dw3": 4}}


@pytest.mark.cuda
@pytest.mark.parametrize("lr_size", [16, 64])
@pytest.mark.parametrize("kind", list(FED_STEP_LAUNCHES))
def test_lightweight_step_grads(cuda, kind, lr_size):
    """The lightweight model's train step (live BatchNorm) and its
    frozen-statistics step, float32, batch 8: output, loss, every gradient
    and every new running statistic on the kernel route against the plain
    route (``diag.federated``), at the conv chain's float32 level; the
    launches of one step."""
    from nerve_tpu_torch.diag import federated as diag_fed

    model = diag_fed.fed_model(cuda)
    lr, hr = diag_fed.client_batch(cuda, lr_size)
    launches = diag_fed.step_launches(model, lr, hr)[kind]
    assert launches == {"forward": FED_STEP_LAUNCHES[kind], "backward": {}}, launches
    tensors = diag_fed.compare_routes(model, lr, hr)[kind]
    limit = LIMITS["conv_chain"][0]
    assert diag_fed.grads_rel_l2(tensors) <= limit
    for name, st in tensors.items():
        # A BatchNorm gradient is a sum over B·H·W terms that cancel.
        rel = 10 * limit if name.startswith("grad ") else limit
        assert st["max_abs"] <= rel * st["scale"], (name, st)


@pytest.mark.cuda
def test_int8_sites_in_train_mode(cuda):
    """The flagship's int8 configuration in ``.train()`` (as the JAX package
    runs it): the five chain sites run their float layers (10
    ``conv_chain``, no ``conv_chain_int8``), the RDB stack stays int8 (8
    ``rdb_int8`` and its input's ``quantize_i8``), the output carries a
    gradient, and the stack's parameters get none."""
    model = diag_conv.seeded_model(cuda, 0, quantized=True, quantized_chains=True)
    g = torch.Generator().manual_seed(19)
    video = torch.rand((1, 3, 32, 48, 3), generator=g).to(cuda)
    quantize_sr(model, video, device=cuda)
    dispatch.reset_launches()
    out = model.train()(video)
    torch.cuda.synchronize()
    launched = {k: v for k, v in dispatch.launches.items() if v}
    assert launched.get("conv_chain") == 10 and "conv_chain_int8" not in launched
    assert launched.get("rdb_int8") == 8 and launched.get("quantize_i8") == 1
    out.square().mean().backward()
    assert all(p.grad is None for k, p in model.named_parameters() if k.startswith("rdbs."))
    assert model.gff.kernel.grad is not None


@pytest.mark.cuda
def test_bn_grads_against_float64(cuda):
    """The BatchNorm scale and bias gradients of the
    flagship's bfloat16 train step (64/8, batch 16, 64²) and of the
    lightweight model's float32 train step (batch 8, LR 64²), each against
    the same step in float64 through the plain versions: the kernel route's
    worst error (relative L2 and max|Δ| of max|float64|) within 2× of the
    plain route's in the step's dtype (``diag.recovery``)."""
    from nerve_tpu_torch.diag import recovery as diag_recovery

    for name, r in diag_recovery.bn_grads_vs_float64(cuda).items():
        assert r["within_2x"], (name, r)


@pytest.mark.cuda
def test_recovery_step_card_vs_cpu(cuda):
    """One recovery train step (base 8, batch 2, 32², float32) on the card
    against the CPU from the same weights: the loss within 1e-5 relative,
    the running statistics within 1e-5 of max|CPU|, each gradient within
    1e-4 in relative L2 or no farther from the float64 step than the CPU's."""
    from nerve_tpu_torch.diag import recovery as diag_recovery

    r = diag_recovery.step_against_cpu(cuda, base=8, batch=2, size=32)
    assert r["loss_rel"] <= 1e-5 and r["stats_rel"] <= 1e-5, r
    for k, v in r["grads"].items():
        assert v["rel_l2"] <= 1e-4 or v["card_vs_f64"] <= v["cpu_vs_f64"], (k, v)


@pytest.mark.cuda
def test_abr_env_card_vs_cpu(cuda):
    """``TorchStreamingEnv`` over 512 streams for 128 steps (auto-resets),
    the same draws and actions on the card and on the CPU: observations,
    rewards and state within ``diag.abr.ENV_LIMIT`` of max|CPU|, ``done``
    equal."""
    from nerve_tpu_torch.diag import abr as diag_abr

    r = diag_abr.env_against_cpu(cuda, n=512, steps=128)
    assert r["ends"] > 0 and diag_abr.env_ok(r), r


@pytest.mark.cuda
def test_abr_update_card_vs_cpu(cuda):
    """One PPO update (hidden 64 x 64, 4 epochs, 512 transitions of a CPU
    rollout) on the card and on the CPU from the same parameters: changes,
    moments and metrics at ``diag.abr``'s limits."""
    from nerve_tpu_torch.abr import ABRConfig
    from nerve_tpu_torch.diag import abr as diag_abr

    cfg = ABRConfig(hidden_dims=(64, 64), update_epochs=4, buffer_capacity=512)
    r = diag_abr.update_against_cpu(cuda, cfg, reps=1)
    assert diag_abr.update_ok(r), r


@pytest.mark.cuda
def test_drift_mmd_card_vs_cpu(cuda):
    """``DriftDetector("mmd")`` on the card and on the CPU (600 x 16, the
    same seed): scores within ``diag.abr.DRIFT_REL``, decisions equal, no
    drift unshifted, drift shifted."""
    from nerve_tpu_torch.diag import abr as diag_abr

    assert diag_abr.drift_ok(diag_abr.drift_against_cpu(cuda, 600, 16, reps=1))


def _nccl_world1(tmp_path):
    from nerve_tpu_torch import parallel

    parallel.init_distributed("nccl", f"file://{tmp_path / 'init'}", 1, 0, "cuda")
    return parallel.make_mesh(device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spatial_sr_nccl_world1(cuda, tmp_path, dtype):
    """``spatial_sr_apply`` at NCCL world size 1 (the halos zero, the CBAM
    pool's all-reduce real; one card takes one NCCL rank): a seeded flagship
    (16 features, 2 RDBs, flow ½), 72 × 40 frames, halo 16; the same
    launches as the one-card forward, the interior rows (2·24 from each
    edge) within the RDB's level of its output."""
    import torch.distributed as dist

    from nerve_tpu_torch.models import SuperResolutionNet
    from nerve_tpu_torch.parallel import spatial_sr_apply

    model = diag_conv.seed_all(SuperResolutionNet(
        scale_factor=2, num_features=16, num_residual_blocks=2, temporal_window=1,
        flow_downsample=2, dtype=dtype, device=cuda).eval(), 3)
    frames = torch.rand((1, 3, 72, 40, 3), generator=torch.Generator().manual_seed(4)).to(cuda)
    dispatch.reset_launches()
    want = model(frames)
    one = dict(dispatch.launches)
    mesh = _nccl_world1(tmp_path)
    try:
        dispatch.reset_launches()
        got = spatial_sr_apply(model, frames, mesh, halo=16)
        assert dict(dispatch.launches) == one and one["rdb"] == 2
    finally:
        dist.destroy_process_group()
    r = 2 * 24
    _check("rdb", got[:, r:-r], want[:, r:-r], dtype)


@pytest.mark.cuda
def test_data_parallel_step_nccl_world1(cuda, tmp_path):
    """The data-parallel train step at NCCL world size 1 against the
    one-card step (a seeded 16 / 2 flagship in bfloat16, batch 4, 32²; 3
    steps): the launches of each step equal, the losses within 1e-3
    relative, the parameters within 5e-2 of the change in L2."""
    import torch.distributed as dist

    from nerve_tpu_torch import training
    from nerve_tpu_torch.diag import train as diag_train

    batches = diag_train.train_batches(cuda, 3, lr_size=32, batch=4)
    runs = {}
    mesh = _nccl_world1(tmp_path)
    try:
        for name, m in (("one", None), ("dp", mesh)):
            model = diag_train.train_model(cuda, seed=2, features=16, blocks=2)
            p0 = torch.cat([p.detach().flatten() for p in model.parameters()])
            state, _ = diag_train.step_fn(model, steps=4)
            step = training.make_sr_train_step(model, mesh=m)
            losses, launches = [], []
            for lr, hr in batches:
                dispatch.reset_launches()
                losses.append(step(state, lr, hr)[1]["loss"].item())
                launches.append(dict(dispatch.launches))
            runs[name] = (losses, launches, p0,
                          torch.cat([p.detach().flatten() for p in model.parameters()]))
    finally:
        dist.destroy_process_group()
    (l1, c1, p0, q1), (l2, c2, _p, q2) = runs["one"], runs["dp"]
    assert c1 == c2 and c1[0]["rdb"] == 2
    assert all(abs(a - b) <= 1e-3 * abs(b) for a, b in zip(l2, l1))
    assert (q2 - q1).norm() <= 5e-2 * (q1 - p0).norm()


@pytest.mark.cuda
def test_spatial_gloo_ranks_share_the_card(cuda, tmp_path):
    """Two gloo ranks on the one card (``parallel.launch.run_cases``): the
    seeded bfloat16 lightweight model height-sharded, ``"packed"``, against
    the one-card forward on the interior rows, 1 ``d2s_packed`` a rank."""
    from nerve_tpu_torch.parallel import launch

    light = diag_conv.seeded_lightweight(cuda, 5)
    frame = torch.rand((1, 96, 64, 3), generator=torch.Generator().manual_seed(6))
    want = light(frame.to(cuda), "packed").cpu()
    spec = {"models": {"light": {"kind": "lightweight", "config": {"scale_factor": 2},
                                 "dtype": "bfloat16"}},
            "cases": [{"name": "light", "fn": "light", "model": "light", "mesh": [1, 1, 2],
                       "input": "frame", "halo": 8, "layout": "packed"}]}
    spec_dir = launch.write_spec(tmp_path, spec, {**launch.state_arrays("light", light),
                                                  "x/frame": frame.numpy()})
    launch.spawn(launch.run_cases, 2, "gloo", "cuda", args=(str(spec_dir),), timeout=300)
    res = torch.load(spec_dir / "result.pt")["light"]
    assert all(lc.get("d2s_packed") == 1 for lc in res["launches"]), res["launches"]
    got = res["out"]
    assert got.shape == want.shape
    _check("conv_chain", got[:, 16:-16], want[:, 16:-16], torch.bfloat16)
