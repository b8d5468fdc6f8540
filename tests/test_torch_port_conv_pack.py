"""The Python that the bf16 dense-convolution kernel depends on, on the CPU.

``csrc/conv_chain.cu`` reads its weights as the image of
``ops.conv_chain.pack_conv_weights`` and its input by the rule of
``ops.conv_chain.input_route``; neither can be checked against the kernel
here, so their layouts and rules are held to what the kernel's source says.
numpy and torch only, no JAX.
"""

import numpy as np
import pytest
import torch

from nerve_tpu_torch import ops
from nerve_tpu_torch.ops import conv_chain


def _t(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(3, 3, 20, 12), (1, 1, 40, 130), (3, 3, 3, 2),
                                   (3, 3, 192, 32), (3, 3, 81, 128)])
def test_pack_layout_unpacks_to_bf16_weights(shape):
    """Element (ky, kx, ci, co) sits at [n-tile][chunk][tap][k half][n / 8]
    [n % 8][k % 8] of the image, as the kernel's B descriptors read it;
    every other element is zero."""
    k, _k, cin, cout = shape
    w = _t(np.random.default_rng(0), *shape)
    image = conv_chain.pack_conv_weights(w)
    nt = conv_chain.n_tile(cout)
    ncot, nch = -(-cout // nt), -(-cin // 16)
    assert image.dtype == torch.bfloat16 and image.ndim == 1
    assert image.numel() == ncot * nch * k * k * 16 * nt
    ky, kx, ci, co = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    tap, chunk, kh, k8 = ky * k + kx, ci // 16, (ci % 16) // 8, ci % 8
    cot, n8, n = co // nt, (co % nt) // 8, co % 8
    idx = ((((((cot * nch + chunk) * k * k + tap) * 2 + kh) * (nt // 8) + n8) * 8 + n) * 8 + k8)
    flat = image.float()
    assert torch.equal(flat[torch.from_numpy(idx)], w.bfloat16().float())
    rest = torch.ones(image.numel(), dtype=torch.bool)
    rest[torch.from_numpy(idx.ravel())] = False
    assert not flat[rest].any()


def test_n_tile():
    assert [conv_chain.n_tile(c) for c in (2, 3, 8, 12, 16, 32, 64, 81, 128, 200)] == [
        8, 8, 8, 16, 16, 32, 64, 128, 128, 128]


def _nhwc(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case,route", [
    ("features", "tma"),          # 64 channels, read in place
    ("rdb_slot", "tma"),          # the leading 96 of a 224-channel buffer
    ("attention_list", "tma"),    # three 64-channel frames, no concatenation
    ("head", "padded"),           # 3 channels: 6-byte pixels
    ("flow_volume", "padded"),    # 81 channels: 162-byte pixels
    ("ragged_list", "padded"),    # three 4-channel parts
    ("unequal_list", "padded"),   # parts of 64 and 32 channels
    ("eight_wide_list", "padded"),  # 16-channel chunks would straddle parts
    ("four_parts", "padded"),     # more parts than the kernel's three maps
    ("strided_view", "padded"),   # not contiguous
    ("misaligned", "padded"),     # starts 8 bytes into its storage
])
def test_input_route(case, route):
    buf = _nhwc(1, 5, 7, 72)
    parts, cin = {
        "features": ([_nhwc(1, 5, 7, 64)], 64),
        "rdb_slot": ([_nhwc(1, 5, 7, 224)], 96),
        "attention_list": ([_nhwc(1, 5, 7, 64)] * 3, 192),
        "head": ([_nhwc(1, 5, 7, 3)], 3),
        "flow_volume": ([_nhwc(2, 5, 7, 81)], 81),
        "ragged_list": ([_nhwc(1, 5, 7, 4)] * 3, 12),
        "unequal_list": ([_nhwc(1, 5, 7, 64), _nhwc(1, 5, 7, 32)], 96),
        "eight_wide_list": ([_nhwc(1, 5, 7, 8)] * 3, 24),
        "four_parts": ([_nhwc(1, 5, 7, 16)] * 4, 64),
        "strided_view": ([buf[..., :64]], 64),
        "misaligned": ([buf.view(-1)[4:4 + 5 * 7 * 64].view(1, 5, 7, 64)], 64),
    }[case]
    assert conv_chain.input_route(parts, cin) == route


@pytest.mark.parametrize("parts,cin", [
    ([_nhwc(1, 5, 7, 64), _nhwc(1, 6, 7, 64)], 128),  # sizes differ
    ([_nhwc(1, 5, 7, 32)], 64),                       # too few channels
    ([_nhwc(1, 5, 7, 32)] * 3, 64),                   # a list holds more than cin
    ([torch.zeros(5, 7, 32, dtype=torch.bfloat16)], 32),  # not NHWC
])
def test_input_route_raises(parts, cin):
    with pytest.raises(ValueError):
        conv_chain.input_route(parts, cin)


def test_padded_input():
    rng = np.random.default_rng(1)
    x = _t(rng, 2, 3, 5, 81).bfloat16()
    got = conv_chain.padded_input([x], 81)
    assert got.shape == (2, 3, 5, 88) and got.is_contiguous()
    assert torch.equal(got[..., :81], x) and not got[..., 81:].any()
    parts = [_t(rng, 1, 3, 5, 4).bfloat16() for _ in range(3)]
    got = conv_chain.padded_input(parts, 12)
    assert got.shape == (1, 3, 5, 16)
    assert torch.equal(got[..., :12], torch.cat(parts, -1)) and not got[..., 12:].any()
    rdb = _t(rng, 1, 3, 5, 36).bfloat16()  # the leading 21 of a wider buffer
    assert torch.equal(conv_chain.padded_input([rdb], 21)[..., :21], rdb[..., :21])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_chain_list_input(dtype):
    """A list input gives what its concatenation gives."""
    rng = np.random.default_rng(2)
    parts = [_t(rng, 1, 6, 9, 8).to(dtype) for _ in range(3)]
    params = [(_t(rng, 3, 3, 24, 16) * 0.1, _t(rng, 16) * 0.1, "relu"),
              (_t(rng, 1, 1, 16, 3) * 0.2, _t(rng, 3) * 0.1, "none")]
    got = ops.conv_chain_apply(parts, params)
    assert torch.equal(got, ops.conv_chain_apply(torch.cat(parts, -1), params))
    assert got.shape == (1, 6, 9, 3) and got.dtype == dtype
