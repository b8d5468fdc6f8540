"""The Python that the dense-convolution kernels depend on, on the CPU.

``csrc/conv_chain.cu`` reads its weights as the image of
``ops.conv_chain.pack_conv_weights`` and its input by the rule of
``ops.conv_chain.input_route``; ``csrc/conv_int8.cu`` reads its weights as
the image of ``ops.conv_chain_int8.pack_i8_weights``, which a served model
packs once and keeps with its int8 state (``QuantState.packed``). None of them can be checked against the kernels here, so
their layouts and rules are held to what the kernels' sources say. numpy
and torch only, no JAX.
"""

import numpy as np
import pytest
import torch

from nerve_tpu_torch import ops
from nerve_tpu_torch.models.layers import QuantizableConv
from nerve_tpu_torch.ops import conv_chain, conv_chain_int8, dispatch, rdb_int8


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


def _wire_i8(kind, scheme, cout):
    """An int8 layer in the wire format: (rows (cin, taps·ncols) without the
    leading zero slot, taps, ncols, cin), quantised by the port's own
    quantisers: a conv-chain layer per column, or an RDB dense layer (the
    second of its block, cin = 5 + cout) per channel."""
    g = torch.Generator().manual_seed(cout)
    if scheme == "per_channel":
        c, cin, params = 5, 5, []
        for _ in range(2):
            params += [torch.randn((3, 3, cin, cout), generator=g), torch.randn(cout, generator=g)]
            cin += cout
        params += [torch.randn((cin, c), generator=g), torch.randn(c, generator=g)]
        wq, _dq, _meta = rdb_int8.quantize_rdb_block(params, c, torch.rand(3, generator=g) + 0.5,
                                                     per_channel=True)
        return wq[1][rdb_int8.FEAT_OFF:], 9, cout, c + cout
    k, cin = (3, 21) if kind == "3x3" else (1, 40)
    layer = (torch.randn((k, k, cin, cout), generator=g), torch.randn(cout, generator=g), "none")
    (wq, _meta), = conv_chain_int8.quantize_conv_chain([layer], torch.rand(2, generator=g) + 0.5)[0]
    ncols = wq.shape[1] // (k * k)
    return wq[conv_chain_int8.BIAS_SLOT:], k * k, ncols, cin


@pytest.mark.parametrize("cout", [2, 3, 12, 32, 64, 128])
@pytest.mark.parametrize("kind,scheme", [("3x3", "per_column"), ("1x1", "per_column"),
                                         ("3x3", "per_channel")])
def test_pack_i8_layout(kind, scheme, cout):
    """Wire-format element (ci, tap·ncols + co) sits at [n-tile][chunk][tap]
    [k half][n / 8][n % 8][k % 16] of the int8 image, as the int8 kernel's B
    descriptors read it (K-major core matrices of 8 output x 16 input
    channels); every other byte is zero. Per-channel quantisation shares a
    factor across a channel's nine tap columns and packs the same way (there
    is no per-channel 1x1 layer)."""
    wi, taps, ncols, cin = _wire_i8(kind, scheme, cout)
    assert wi.dtype == torch.int8 and wi.shape == (cin, taps * ncols)
    image = conv_chain_int8.pack_i8_weights(wi, taps, ncols, cout)
    nt = conv_chain_int8.n_tile_i8(cout)
    ncot, nch = -(-cout // nt), -(-cin // 32)
    assert image.dtype == torch.int8 and image.shape == (ncot * nch * taps * 32 * nt,)
    ci, tap, co = np.meshgrid(np.arange(cin), np.arange(taps), np.arange(cout), indexing="ij")
    cot, n8, n = co // nt, (co % nt) // 8, co % 8
    chunk, kh, k16 = ci // 32, (ci % 32) // 16, ci % 16
    idx = ((((((cot * nch + chunk) * taps + tap) * 2 + kh) * (nt // 8) + n8) * 8 + n) * 16 + k16)
    want = wi.reshape(cin, taps, ncols)[:, :, :cout]
    assert torch.equal(image[torch.from_numpy(idx)], want)
    rest = torch.ones(image.numel(), dtype=torch.bool)
    rest[torch.from_numpy(idx.ravel())] = False
    assert not image[rest].any()


def test_n_tile_i8():
    assert [conv_chain_int8.n_tile_i8(c) for c in (2, 3, 8, 12, 16, 24, 32, 64, 128)] == [
        8, 8, 8, 16, 16, 32, 32, 32, 32]


def test_pack_is_kept_until_the_weights_change():
    """A served int8 site packs its weights once and keeps them, also when it
    was built inside inference mode (its buffers then keep no version
    counter); a recalibration, ``load_state_dict`` or a move repacks it."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((1, 5, 6, 8), generator=g)

    def kept(conv):
        return conv.qconv.packed(16, lambda: pytest.fail("the pack was not kept"))

    def run(conv, x, mode="serve"):
        conv.chain_quant = mode
        with torch.inference_mode():
            conv(x)
        conv.chain_quant = "serve"

    for built_in_inference in (False, True):
        with torch.inference_mode(built_in_inference):
            conv = QuantizableConv(16, 8, "relu", chain_quant="serve", device="cpu",
                                   generator=g).eval()
        dispatch.reset_launches()
        run(conv, x, "calibrate")
        for _ in range(3):
            run(conv, x)
        assert dispatch.packs["int8"] == 1
        first = kept(conv)
        run(conv, 3 * x, "calibrate")
        run(conv, x)
        qlayers, _s = conv.qconv.value()
        fresh = conv_chain_int8.packed_chain(qlayers, 16)
        assert dispatch.packs["int8"] == 3 and kept(conv) is not first  # one is ``fresh``
        assert not torch.equal(kept(conv)[0].dq, first[0].dq)
        assert all(torch.equal(a, b) for a, b in zip(kept(conv)[0], fresh[0])
                   if isinstance(a, torch.Tensor))
        with torch.inference_mode():
            conv.load_state_dict(conv.state_dict())
        run(conv, x)
        with torch.inference_mode():
            conv.to("cpu")
        run(conv, x)
        run(conv, x)
        assert dispatch.packs["int8"] == 5
