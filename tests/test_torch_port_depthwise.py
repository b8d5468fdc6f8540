"""The depthwise 3×3 layer and the packed depth-to-space of nerve_tpu_torch
against nerve_tpu, and the wrappers' rules, on the CPU.

The plain depthwise layer (what a CPU tensor runs; the CUDA kernel
``csrc/dwconv3.cu`` is held against it on the card) is held bit-exact in
bfloat16 against the JAX package's reference formulation ``_chain_xla``,
compiled with ``xla_allow_excess_precision`` off so that XLA rounds where
its source says, at the lightweight (32) and ``FeatureExtractor`` (64)
widths and wider, with float32 weights that bfloat16 does not represent (both round
them to bfloat16 first). The plain packed depth-to-space is held bit-exact
against ``depth_to_space_packed(use_pallas=False)`` in bfloat16 at the
serving layout. The depthwise layer is also held at 96 and 128 channels,
wider than one of the kernel's 64-channel slices (the reference takes any
C). The route rule of the depthwise kernel and its weight operand are pure
Python and tested here; the kernels run in ``tests/test_torch_port_cuda.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerve_tpu import ops as jops
from nerve_tpu.ops import conv_chain as jcc
from nerve_tpu_torch import ops
from nerve_tpu_torch.ops import conv_chain

pixel_shuffle = importlib.import_module("nerve_tpu_torch.ops.pixel_shuffle")


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


@pytest.mark.parametrize("act", ["relu", "none"])
@pytest.mark.parametrize("c", [32, 64, 96, 128])
def test_plain_depthwise_bf16_bit_exact_vs_xla(c, act):
    rng = np.random.default_rng(20 + c)
    x = rng.standard_normal((2, 7, 9, c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c)) / 3).astype(np.float32)
    b = (rng.standard_normal((c,)) * 0.1).astype(np.float32)
    assert not np.array_equal(w, _bf16(w).float().numpy())  # the rounding is exercised
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = jax.jit(lambda a: jcc._chain_xla(a, [jnp.asarray(w)], [jnp.asarray(b)], [act]),
                  compiler_options={"xla_allow_excess_precision": False})(xb)
    got = ops.conv_chain_apply(_bf16(x), [(torch.from_numpy(w), torch.from_numpy(b), act)])
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("shape,dtype,aligned,route", [
    ((1, 1080, 1920, 32), torch.bfloat16, True, "tma"),   # the lightweight serving layer
    ((1, 1080, 1920, 64), torch.bfloat16, True, "tma"),   # the FeatureExtractor's width
    ((2, 97, 261, 8), torch.bfloat16, True, "tma"),
    ((2, 97, 261, 8), torch.float32, True, "tma"),
    ((2, 97, 261, 12), torch.float32, True, "tma"),       # 48-byte pixels
    ((2, 97, 261, 3), torch.bfloat16, True, "tile"),
    ((2, 97, 261, 12), torch.bfloat16, True, "tile"),
    ((2, 97, 261, 20), torch.bfloat16, True, "tile"),
    ((2, 97, 261, 3), torch.float32, True, "tile"),
    ((1, 1080, 1920, 32), torch.bfloat16, False, "tile"),  # a base off 16 bytes
])
def test_dwconv3_route(shape, dtype, aligned, route):
    assert conv_chain.dwconv3_route(shape, dtype, aligned) == route


def test_dwconv3_route_of_tensors():
    """The wrapper's rule reads the data pointers: a view 2 elements in is
    off 16 bytes."""
    base = torch.zeros(2 * 5 * 7 * 32 + 2, dtype=torch.bfloat16)
    x = base[2:].view(2, 5, 7, 32)
    out = torch.empty_like(x)
    assert conv_chain._dw_route(base[:-2].view(2, 5, 7, 32), out) == "tma"
    assert conv_chain._dw_route(x, out) == "tile"


def test_dw_weights_passed_as_they_are():
    """A float32 contiguous (3, 3, C) weight, as the models keep it, goes to
    the kernel as it is (no ATen op per call); any other is rounded to the
    input dtype once and widened."""
    rng = np.random.default_rng(3)
    x = torch.zeros((1, 4, 5, 16), dtype=torch.bfloat16)
    out, b = torch.empty_like(x), torch.zeros(16)
    w = torch.from_numpy((rng.standard_normal((3, 3, 16)) / 3).astype(np.float32))
    assert conv_chain._dw_operands(x, w, b, out) is w
    w64 = w.double() + 1e-9
    got = conv_chain._dw_operands(x, w64, b, out)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, w64.to(torch.bfloat16).float())
    wt = w.permute(1, 0, 2)
    assert torch.equal(conv_chain._dw_operands(x, wt, b, out), wt.to(torch.bfloat16).float())
    with pytest.raises(ValueError, match="float32 bias"):
        conv_chain._dw_operands(x, w, b.double(), out)
    with pytest.raises(ValueError, match="does not fit"):
        conv_chain._dw_operands(x, w[..., :8], b, out)


def test_d2s_packed_plain_bf16_serving_layout_vs_jax():
    """s = 2, C = 3 (12 phase channels), bfloat16: the serving epilogue's layout."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 7, 12)).astype(np.float32)
    ref = jops.depth_to_space_packed(jnp.asarray(x, jnp.bfloat16), 2, use_pallas=False)
    got = pixel_shuffle.depth_to_space_packed_plain(_bf16(x), 2)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 10, 42)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
