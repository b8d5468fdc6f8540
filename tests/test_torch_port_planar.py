"""The planar chain's weight pack and the probe's plain path, on the CPU.

A pack (``ops.planar_chain.packed_planar_chain``) is made once for a chain,
a dtype and a device and passed to ``planar_chain_apply`` as ``packed=``;
the wrapper refuses one made for another chain, dtype or device, or from
other weight tensors or weights changed since, on either device. On the
CPU the call takes the plain version, whose result must not depend on
whether a pack is given; both are held against the JAX
reference formulation ``_planar_xla`` (bit-exact in bfloat16, 1e-5 of
max|ref| in float32, as in ``tests/test_torch_port_lightweight.py``). The
kernels themselves run in ``tests/test_torch_port_cuda.py`` on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerve_tpu.ops import planar_chain as jpc
from nerve_tpu_torch import ops
from nerve_tpu_torch.diag import probe
from nerve_tpu_torch.ops import dispatch
from nerve_tpu_torch.ops import planar_chain as pc

exact_jit = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _body(rng, c=8, cin=3, cout=12, blocks=2):
    """A lightweight-shaped chain: head 3×3, (dw3, 1×1) blocks, tail 3×3."""
    p = [(rng.standard_normal((3, 3, cin, c)) / np.sqrt(9 * cin), rng.standard_normal(c) * 0.1,
          "relu")]
    for _ in range(blocks):
        p.append((rng.standard_normal((3, 3, c)) / 3, rng.standard_normal(c) * 0.1, "none"))
        p.append((rng.standard_normal((1, 1, c, c)) / np.sqrt(c), rng.standard_normal(c) * 0.1,
                  "relu"))
    p.append((rng.standard_normal((3, 3, c, cout)) / np.sqrt(9 * c),
              rng.standard_normal(cout) * 0.1, "none"))
    return [(w.astype(np.float32), b.astype(np.float32), a) for w, b, a in p]


def _torch(params):
    return [(torch.from_numpy(w), torch.from_numpy(b), a) for w, b, a in params]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_path_same_with_and_without_pack(dtype):
    rng = np.random.default_rng(40)
    params = _body(rng)
    x = rng.random((2, 3, 9, 14)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    xt, tp = torch.from_numpy(x).to(tdt), _torch(params)
    pk = pc.packed_planar_chain(tp, tdt, "cpu")
    dispatch.reset_launches()
    with_pack = ops.planar_chain_apply(xt, tp, packed=pk)
    without = ops.planar_chain_apply(xt, tp)
    assert not any(dispatch.launches.values())
    assert torch.equal(with_pack, without)
    ref = np.asarray(exact_jit(jpc._planar_xla, static_argnums=3)(
        jnp.asarray(x, jdt), [jnp.asarray(w) for w, _, _ in params],
        [jnp.asarray(b) for _, b, _ in params], tuple(a for *_, a in params)).astype(jnp.float32))
    got = with_pack.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * float(np.abs(ref).max()))


# A pack that does not fit the call: another chain (a layer's width, an
# activation, a layer fewer), another dtype, another device.
MISMATCHES = {
    "width": lambda rng: (_body(rng, c=16), torch.bfloat16, "cpu", "chain"),
    "activation": lambda rng: ([(w, b, "none") for w, b, _a in _body(rng)], torch.bfloat16,
                               "cpu", "chain"),
    "layers": lambda rng: (_body(rng, blocks=1), torch.bfloat16, "cpu", "chain"),
    "dtype": lambda rng: (_body(rng), torch.float32, "cpu", "bfloat16 on cpu"),
    "device": lambda rng: (_body(rng), torch.bfloat16, "meta", "bfloat16 on meta"),
}


@pytest.mark.parametrize("mismatch", list(MISMATCHES))
def test_refuses_a_pack_of_another_chain_dtype_or_device(mismatch):
    rng = np.random.default_rng(41)
    params = _torch(_body(rng))
    other, dtype, device, says = MISMATCHES[mismatch](rng)
    pk = pc.packed_planar_chain(_torch(other), dtype, device)
    x = torch.rand((1, 3, 6, 7)).to(torch.bfloat16)
    with pytest.raises(ValueError, match=f"pack made for .*{says}" if mismatch in (
            "dtype", "device") else "pack made for the chain"):
        ops.planar_chain_apply(x, params, packed=pk)


@pytest.mark.parametrize("change", ["other tensors", "weight in place", "bias in place"])
def test_refuses_a_pack_of_other_or_changed_weights(change):
    """Another model's weights of the same chain, or this chain's weights
    changed in place after packing (``load_state_dict`` copies in place)."""
    rng = np.random.default_rng(43)
    params = _torch(_body(rng))
    x = torch.rand((1, 3, 6, 7)).to(torch.bfloat16)
    if change == "other tensors":
        pk = pc.packed_planar_chain(_torch(_body(rng)), torch.bfloat16, "cpu")
    else:
        pk = pc.packed_planar_chain(params, torch.bfloat16, "cpu")
        ops.planar_chain_apply(x, params, packed=pk)
        with torch.no_grad():
            params[1][0 if change == "weight in place" else 1].mul_(2.0)
    with pytest.raises(ValueError, match="pack made from other weights"):
        ops.planar_chain_apply(x, params, packed=pk)
    repacked = pc.packed_planar_chain(params, torch.bfloat16, "cpu")
    assert torch.equal(ops.planar_chain_apply(x, params, packed=repacked),
                       ops.planar_chain_apply(x, params))


def test_pack_of_inference_tensors_checks_their_identity():
    """Inference tensors keep no version counter: a pack of them is held to
    the same tensors."""
    rng = np.random.default_rng(44)
    with torch.inference_mode():
        params = _torch(_body(rng))
        others = [(w.clone(), b.clone(), a) for w, b, a in params]
        pk = pc.packed_planar_chain(params, torch.bfloat16, "cpu")
    x = torch.rand((1, 3, 6, 7)).to(torch.bfloat16)
    assert torch.equal(ops.planar_chain_apply(x, params, packed=pk),
                       ops.planar_chain_apply(x, params))
    with pytest.raises(ValueError, match="pack made from other weights"):
        ops.planar_chain_apply(x, others, packed=pk)


def test_pack_records_its_chain_and_folds_the_bf16_head():
    rng = np.random.default_rng(42)
    params = _torch(_body(rng))
    pk = pc.packed_planar_chain(params, torch.bfloat16, "cpu")
    assert pk.specs == tuple(pc._layer_specs(params)) and pk.dtype == torch.bfloat16
    assert pk.wpack.dtype == torch.uint8 and pk.wpack.numel() % 16 == 0
    assert pk.table.reshape(-1, 6)[0, 0] == pc.HEAD_CODE
    # Only a first 3x3 layer of at most three channels, in bfloat16, folds.
    assert not pc.folds_head(pc._layer_specs(_torch(_body(rng, cin=4))), torch.bfloat16)
    assert not pc.folds_head(pc._layer_specs(params), torch.float32)
    assert pc.packed_planar_chain(params, torch.float32, "cpu").table[0] == 0


@pytest.mark.parametrize("n", [1, 5, 1024, 4099])
def test_probe_plain_on_sizes_and_offsets(n):
    base = torch.rand(n + 1, generator=torch.Generator().manual_seed(n))
    for a in (base[:n], base[1:]):
        dispatch.reset_launches()
        assert torch.equal(probe.probe_scale2(a), a * 2)
        assert dispatch.launches["probe"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chain", ["body", "dw_last"])
def test_plain_path_non_finite_vs_jax(dtype, chain):
    """One +Inf, one -Inf and one NaN in the input: the plain path (what
    the kernel is held to on the card) is not finite exactly where
    ``_planar_xla`` is not, and its finite values are the reference's
    (bit-exact in bfloat16, 1e-5 of max|ref| in float32). ``dw_last`` ends
    in two depthwise layers, the first with relu, so a value stays in its
    channel up to the output."""
    rng = np.random.default_rng(42)
    params = _body(rng)
    if chain == "dw_last":
        params = params[:1] + [(rng.standard_normal((3, 3, 8)).astype(np.float32) / 3,
                                (rng.standard_normal(8) * 0.1).astype(np.float32), a)
                               for a in ("relu", "none")]
    x = rng.random((2, 3, 13, 21)).astype(np.float32)
    x[0, 0, 3, 4], x[0, 1, 8, 15], x[1, 2, 6, 10] = np.inf, -np.inf, np.nan
    jdt, tdt = DTYPES[dtype]
    got = ops.planar_chain_apply(torch.from_numpy(x).to(tdt), _torch(params)).float().numpy()
    ref = np.asarray(exact_jit(jpc._planar_xla, static_argnums=3)(
        jnp.asarray(x, jdt), [jnp.asarray(w) for w, _, _ in params],
        [jnp.asarray(b) for _, b, _ in params], tuple(a for *_, a in params)).astype(jnp.float32))
    bad = ~np.isfinite(ref)
    assert 0 < bad.sum() < bad.size // 2
    np.testing.assert_array_equal(~np.isfinite(got), bad)
    got, ref = np.where(bad, 0, got), np.where(bad, 0, ref)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * float(np.abs(ref).max()))
