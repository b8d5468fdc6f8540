"""The correlation's rounding contract and the kernel's input route, on the CPU.

The exact-sum input (``diag.correlation.exact_sum_inputs``: constant fields
whose bfloat16 sums are exact in any order, and differ where a product is
not rounded to bfloat16) goes through the plain version, the JAX XLA
formulation and both Pallas kernels in interpret mode, compiled with
``xla_allow_excess_precision`` off so that XLA rounds each product as the
source says: all four agree bit for bit, and the same sum over float32
products gives another answer. The card test of the same input
(``tests/test_torch_port_cuda.py``) therefore fails a kernel that drops the
rounding. Then the wrapper's route into the kernel (``kernel_inputs``):
channel counts whose pixel stride is not a multiple of 16 bytes are padded
with zero channels and the true C is kept for 1/C (the card test holds the
kernel's result on that route against the plain version); and its
refusals, on ``meta`` tensors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nerve_tpu.ops import correlation as jcorr
from nerve_tpu_torch import ops
from nerve_tpu_torch.diag.correlation import exact_sum_inputs
from nerve_tpu_torch.ops import correlation

exact_jit = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})
D = 4
SHAPE = (1, 10, 16, 64)
JAX_KERNELS = {
    "xla": lambda a, b: jcorr._correlation_xla(a, b, D),
    "pallas_planar": lambda a, b: jcorr._correlation_pallas_planar(a, b, D, 8, 16),
    "pallas_nhwc": lambda a, b: jcorr._correlation_pallas(a, b, D, 8, 16),
}


@pytest.fixture(scope="module")
def exact():
    f1, f2, inside = exact_sum_inputs(*SHAPE[:3], SHAPE[3])
    return f1, f2, inside, correlation.correlation_plain(f1, f2, D)


def test_exact_sum_plain_is_the_rounded_sum(exact):
    f1, f2, inside, got = exact
    assert got.dtype == torch.bfloat16
    # Inside the frame every displacement sees the whole field: 2⁻¹⁸ / C.
    assert bool(got[:, D:-D, D:-D].float().eq(inside).all()) and inside == 2.0 ** -24
    # At a corner the displacements that leave the frame read zeros.
    corner = got[0, 0, 0].float().reshape(2 * D + 1, 2 * D + 1)
    assert bool(corner[:D].eq(0).all()) and bool(corner[:, :D].eq(0).all())
    assert bool(corner[D:, D:].eq(inside).all())


@pytest.mark.parametrize("kernel", list(JAX_KERNELS))
def test_exact_sum_matches_jax(exact, kernel):
    f1, f2, _inside, got = exact
    jf1, jf2 = (jnp.asarray(f.float().numpy(), jnp.bfloat16) for f in (f1, f2))
    with pltpu.force_tpu_interpret_mode():
        ref = exact_jit(JAX_KERNELS[kernel])(jf1, jf2)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_float32_products_give_another_sum(exact):
    """The same sum over unrounded products: (1 + 16 · 31) · 2⁻¹⁸ / 64
    inside, which rounds to 496 · 2⁻²⁴ in bfloat16, not 2⁻²⁴."""
    f1, f2, inside, got = exact
    unrounded = correlation.correlation_plain(f1.float(), f2.float(), D).to(torch.bfloat16)
    assert bool(unrounded[:, D:-D, D:-D].float().eq(496 * 2.0 ** -24).all())
    assert not torch.equal(unrounded, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 20])
def test_padded_route_pads_with_zero_channels(dtype, c):
    g = torch.Generator().manual_seed(c)
    f1, f2 = (torch.randn((2, 7, 11, c), generator=g).to(dtype) for _ in range(2))
    f1k, f2k, true_c = correlation.kernel_inputs(f1, f2, 2)
    per16 = 16 // f1.element_size()
    assert true_c == c and f1k.shape[-1] % per16 == 0 and f1k.shape[-1] - c < per16
    assert f1k.is_contiguous() and f2k.is_contiguous()
    assert torch.equal(f1k[..., :c], f1) and torch.equal(f2k[..., :c], f2)
    assert not f1k[..., c:].any() and not f2k[..., c:].any()


def test_aligned_channels_are_read_in_place():
    f1 = torch.randn((1, 4, 5, 64)).to(torch.bfloat16)
    f1k, f2k, c = correlation.kernel_inputs(f1, f1, 4)
    assert c == 64 and f1k.data_ptr() == f1.data_ptr() and f2k.data_ptr() == f1.data_ptr()


def _meta(shape=(1, 6, 7, 8), dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


REFUSALS = {
    "d=0": (lambda: correlation.kernel_inputs(_meta(), _meta(), 0), ValueError, "1 <= d <= 4"),
    "d=5": (lambda: correlation.kernel_inputs(_meta(), _meta(), 5), ValueError, "1 <= d <= 4"),
    "float16": (lambda: correlation.kernel_inputs(_meta(dtype=torch.float16),
                                                  _meta(dtype=torch.float16), 2),
                TypeError, "float32 or bfloat16"),
    "not NHWC": (lambda: correlation.kernel_inputs(_meta((6, 7, 8)), _meta((6, 7, 8)), 2),
                 ValueError, "(B, H, W, C)"),
    "empty": (lambda: correlation.kernel_inputs(_meta((1, 0, 7, 8)), _meta((1, 0, 7, 8)), 2),
              ValueError, "non-empty"),
    "shapes differ": (lambda: ops.correlation_volume(_meta(), _meta((1, 6, 7, 16)), 2),
                      ValueError, "differ"),
    "dtypes differ": (lambda: ops.correlation_volume(_meta(), _meta(dtype=torch.float32), 2),
                      ValueError, "differ"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_kernel_route_refuses(case):
    call, error, says = REFUSALS[case]
    with pytest.raises(error, match=says.replace("(", r"\(").replace(")", r"\)")):
        call()


def test_kernel_inputs_pad_on_meta():
    f1k, f2k, c = correlation.kernel_inputs(_meta((2, 6, 7, 3)), _meta((2, 6, 7, 3)), 4)
    assert c == 3 and tuple(f1k.shape) == (2, 6, 7, 8) and f2k.device.type == "meta"
    f1k, _f2k, c = correlation.kernel_inputs(_meta((2, 6, 7, 3), torch.float32),
                                             _meta((2, 6, 7, 3), torch.float32), 4)
    assert c == 3 and tuple(f1k.shape) == (2, 6, 7, 4)
