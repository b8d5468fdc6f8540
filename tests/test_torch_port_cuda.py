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
scale (one int8 step of a requantised intermediate may flip).
"""

import importlib

import pytest
import torch

from nerve_tpu_torch import ops
from nerve_tpu_torch.ops import (
    conv_chain,
    conv_chain_int8,
    correlation,
    dispatch,
    planar_chain,
    rdb,
    rdb_int8,
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_chain(cuda, dtype):
    g = torch.Generator().manual_seed(2)
    xs = [_rand(g, 2, 9, 35, 4).to(cuda, dtype) for _ in range(3)]
    params = _conv_params(g, [12, 40, 20, 3, 12], [3, 1, 3, 3], cuda)
    _check("conv_chain", ops.conv_chain_apply(xs, params),
           conv_chain.conv_chain_plain(xs, params), dtype)


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
        params = _conv_params(g, [3, 32], [3], cuda)
        for _ in range(4):
            params += [_dw_params(g, 32, "none", cuda), *_conv_params(g, [32, 32], [1], cuda)]
            params[-1] = (*params[-1][:2], "relu")
        params += _conv_params(g, [32, 12], [3], cuda)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rdb(cuda, dtype):
    g = torch.Generator().manual_seed(3)
    plist = [[p.to(dtype) for p in _rdb_params(g, 16, cuda)] for _ in range(2)]
    x = _rand(g, 1, 10, 33, 16).to(cuda, dtype)
    _check("rdb", ops.rdb_chain_apply(x, plist), rdb.rdb_chain_plain(x, plist), dtype)


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
