"""The RDB fusions' Python, on the CPU: what the fusion kernels depend on.

``csrc/rdb.cu``'s bf16 fusion (``lff_wgmma_kernel``) reads its weights as
``ops.conv_chain.pack_conv_weights`` of the (1, 1, C + L·G, C) matrix at the
fusion's N tile of 64, and ``csrc/rdb_int8.cu``'s (``lff_i8_wgmma_kernel``)
as ``ops.conv_chain_int8.pack_i8_weights`` of the wire rows at its N tile
of 32, packed once per int8 state (``PackedBlockI8.lw``). Both stacks keep
two concatenation buffers by ``ops.rdb.stack_plan``. None of this can be
checked against the kernels here, so the layouts are held to an independent
construction of the B descriptors' order, the plan to what each block reads
and writes, the wrappers to the arguments they refuse before any launch,
and the plain versions (what a CPU tensor runs, and the card's yardstick)
to the JAX package at C = 16, C + L·G = 176:

* the bf16 stack's plain version against ``_rdb_xla`` block by block
  (``_rdb_chain_xla``), compiled with ``xla_allow_excess_precision`` off, in
  bfloat16: within the RDB tolerance, 1.56e-2 of max|ref| (the two
  frameworks round bf16 convolution sums at different points);
* the bf16 fusion's plain version alone against ``_rdb_xla``'s fusion
  expression, in bfloat16 at 1.56e-2 and in float32 at 1e-5 of max|ref|
  (float32 sums in another order);
* the int8 stack with bfloat16 activations in both tap schemes against
  ``rdb_chain_int8_xla``: within 4 × its largest activation scale (one int8
  step of a requantised intermediate may flip; ``tests/test_rdb_int8.py``);
  the int8 fusion's plain version requantises by true division.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerve_tpu.ops import rdb as jrdb
from nerve_tpu.ops import rdb_int8 as jr8
from nerve_tpu_torch import ops
from nerve_tpu_torch.ops import conv_chain, rdb
from nerve_tpu_torch.ops import rdb_int8 as r8

RDB_REL = 1.56e-2
XLA_EXACT = {"xla_allow_excess_precision": False}


def _rdb_params(rng, c, layers=5, growth=32):
    params, cin = [], c
    for _ in range(layers):
        params += [rng.standard_normal((3, 3, cin, growth)) / np.sqrt(9 * cin),
                   rng.standard_normal(growth) * 0.1]
        cin += growth
    params += [rng.standard_normal((cin, c)) / np.sqrt(cin), rng.standard_normal(c) * 0.1]
    return [p.astype(np.float32) for p in params]


def _bf16(a):
    """numpy float32 values rounded to bfloat16, as (jax, torch) arrays."""
    t = torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _within(got, ref, rel):
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, f"max|d| {err} > {rel} * {scale}"


# --------------------------------------------------------------------------- #
# The buffer plan
# --------------------------------------------------------------------------- #
PLANS = {
    1: [(0, None)],
    2: [(0, 1), (1, None)],
    8: [(0, 1), (1, 0), (0, 1), (1, 0), (0, 1), (1, 0), (0, 1), (1, None)],
}


@pytest.mark.parametrize("blocks", list(PLANS))
def test_stack_plan(blocks):
    """Block k reads buffer k % 2 (the stack's input is copied into buffer 0
    once) and writes the next block's input into the other buffer, the
    last block the stack's output; no block writes what it reads, so no
    fusion writes in place."""
    plan = rdb.stack_plan(blocks)
    assert plan == PLANS[blocks]
    assert plan[0][0] == 0 and plan[-1][1] is None
    for (src, dst), (nsrc, _ndst) in zip(plan, plan[1:]):
        assert dst == nsrc != src
    assert {src for src, _dst in plan} <= {0, 1}


class _Recorder:
    """Stands in for the launch wrappers: records, per launch, the buffer it
    reads and the one it writes (numbered in order of first use), without
    running anything."""

    def __init__(self):
        self.ids, self.calls, self.tensors = {}, [], {}

    def buf(self, t):
        self.tensors.setdefault(t.data_ptr(), t)
        return self.ids.setdefault(t.data_ptr(), len(self.ids))

    def conv(self, x, out):
        self.calls.append(("dense", self.buf(x), self.buf(out)))

    def lff(self, cat, out):
        out = torch.empty(0) if out is None else out  # the stack's output
        self.calls.append(("lff", self.buf(cat), self.buf(out)))
        return out


def _check_plan(rec, blocks, layers):
    """The buffers are numbered 0 and 1, the stack's output after them."""
    want = []
    for src, dst in rdb.stack_plan(blocks):
        want += [("dense", src, src)] * layers
        want.append(("lff", src, min(blocks, 2) if dst is None else dst))
    assert rec.calls == want


@pytest.mark.parametrize("blocks", list(PLANS))
def test_bf16_stack_follows_the_plan(monkeypatch, blocks):
    """The bf16 wrapper's launches: block k's dense layers read and write
    buffer ``stack_plan(n)[k][0]``, its fusion reads that buffer and writes
    the other (the last block a new output); the stack's input sits in
    channels [0, C) of buffer 0, whose channel stride is ceil8(C + L·G)."""
    rec = _Recorder()
    monkeypatch.setattr(rdb, "conv_layer_launch",
                        lambda x, cin, w, b, out, coff, relu: rec.conv(x, out))
    monkeypatch.setattr(rdb, "lff_launch", lambda cat, lw, lb, out=None: rec.lff(cat, out))
    rng = np.random.default_rng(blocks)
    plist = [[torch.from_numpy(p) for p in _rdb_params(rng, 12)] for _ in range(blocks)]
    x = torch.randn((1, 3, 4, 12)).bfloat16()
    rdb._rdb_chain_kernel(x, plist)
    _check_plan(rec, blocks, 5)
    buf0 = rec.tensors[next(p for p, i in rec.ids.items() if i == 0)]
    assert buf0.shape == (1, 3, 4, 176) and torch.equal(buf0[..., :12], x)


@pytest.mark.parametrize("blocks", list(PLANS))
def test_int8_stack_follows_the_plan(monkeypatch, blocks):
    """The int8 wrapper keeps the same plan (buffers of ceil16(C + L·G))."""
    rng = np.random.default_rng(blocks)
    plist = [[torch.from_numpy(p) for p in _rdb_params(rng, 16, 3, 16)] for _ in range(blocks)]
    x = torch.from_numpy((rng.standard_normal((1, 3, 4, 16)) * 0.5).astype(np.float32))
    q = r8.quantize_rdb_chain(plist, r8.calibrate_rdb_chain(x, plist))
    packed = r8.packed_rdb_chain(q)
    rec = _Recorder()
    monkeypatch.setattr(r8.dispatch, "use_kernel", lambda *t: True)
    monkeypatch.setattr(r8, "quantize_into", lambda xs, s, out, c: rec.buf(out))
    monkeypatch.setattr(r8, "conv_layer_launch_i8",
                        lambda x, layer, out, coff, relu, taps_mode: rec.conv(x, out))
    monkeypatch.setattr(r8, "lff_launch_i8",
                        lambda cat, ccat, lw, ldq, lbias, s_in, s_next, out: rec.lff(cat, out))
    r8.rdb_chain_int8_apply(x, q, packed=packed)
    _check_plan(rec, blocks, 3)
    buf0 = rec.tensors[next(p for p, i in rec.ids.items() if i == 0)]
    assert buf0.shape == (1, 3, 4, 64) and buf0.dtype == torch.int8


# --------------------------------------------------------------------------- #
# The fusions' weight images
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("ccat,c", [(176, 16), (224, 64), (72, 24), (200, 80)])
def test_lff_pack_bf16_layout(ccat, c):
    """Fusion weight (ci, co) sits at [n-tile][chunk][k half][n / 8][n % 8]
    [k % 8] of the bf16 image with 64-wide N tiles and 16-channel chunks
    (one tap), as ``lff_wgmma_kernel``'s B descriptors read it; every other
    element is zero."""
    lw = torch.from_numpy(np.random.default_rng(ccat).standard_normal((ccat, c), np.float32))
    image = conv_chain.pack_conv_weights(lw.reshape(1, 1, ccat, c), rdb.LFF_N_TILE)
    nt, ncot, nch = 64, -(-c // 64), -(-ccat // 16)
    assert image.dtype == torch.bfloat16 and image.shape == (ncot * nch * 16 * nt,)
    ci, co = np.meshgrid(np.arange(ccat), np.arange(c), indexing="ij")
    idx = (((((co // nt) * nch + ci // 16) * 2 + (ci % 16) // 8) * (nt // 8) + (co % nt) // 8)
           * 8 + co % 8) * 8 + ci % 8
    assert torch.equal(image[torch.from_numpy(idx)].float(), lw.bfloat16().float())
    rest = torch.ones(image.numel(), dtype=torch.bool)
    rest[torch.from_numpy(idx.ravel())] = False
    assert not image[rest].float().any()


@pytest.mark.parametrize("c,layers,growth", [(16, 5, 32), (64, 5, 32), (24, 3, 16)])
def test_lff_pack_i8_layout(c, layers, growth):
    """The fusion's wire rows ``wq[L][FEAT_OFF:]`` (ci, co) sit at [n-tile]
    [chunk][k half][n / 8][n % 8][k % 16] of ``PackedBlockI8.lw`` with
    32-wide N tiles and 32-channel chunks, as ``lff_i8_wgmma_kernel``'s B
    descriptors read it; every other byte is zero."""
    rng = np.random.default_rng(c)
    params = [torch.from_numpy(p) for p in _rdb_params(rng, c, layers, growth)]
    scales = torch.rand(layers + 1, generator=torch.Generator().manual_seed(c)) + 0.5
    block = r8.quantize_rdb_block(params, c, scales)
    image = r8.packed_block(block, c, layers, growth, False).lw
    wl = block[0][layers][r8.FEAT_OFF:]
    ccat = c + layers * growth
    assert wl.shape == (ccat, c)
    nt, ncot, nch = 32, -(-c // 32), -(-ccat // 32)
    assert image.dtype == torch.int8 and image.shape == (r8.lff_image_size(ccat, c),)
    assert image.numel() == ncot * nch * 32 * nt
    ci, co = np.meshgrid(np.arange(ccat), np.arange(c), indexing="ij")
    idx = (((((co // nt) * nch + ci // 32) * 2 + (ci % 32) // 16) * (nt // 8) + (co % nt) // 8)
           * 8 + co % 8) * 16 + ci % 16
    assert torch.equal(image[torch.from_numpy(idx)], wl)
    rest = torch.ones(image.numel(), dtype=torch.bool)
    rest[torch.from_numpy(idx.ravel())] = False
    assert not image[rest].any()


# --------------------------------------------------------------------------- #
# The wrappers' checks (before any launch)
# --------------------------------------------------------------------------- #
def _bad_lff_bf16(case):
    cat = torch.zeros((1, 4, 5, 176), dtype=torch.bfloat16)
    lw, lb = torch.zeros((176, 16)), torch.zeros(16)
    out = {"in_place": cat, "narrow": torch.zeros((1, 4, 5, 20), dtype=torch.bfloat16),
           "dtype": torch.zeros((1, 4, 5, 16))}.get(case)
    if case == "stride":  # 172 bf16 channels: 344-byte pixels, not TMA's 16-byte steps
        cat, lw = torch.zeros((1, 4, 5, 172), dtype=torch.bfloat16), torch.zeros((172, 16))
    if case == "wide_weights":
        lw = torch.zeros((180, 16))
    return cat, lw, lb, out, 8 if case == "narrow" else 0


@pytest.mark.parametrize("case", ["in_place", "narrow", "dtype", "stride", "wide_weights"])
def test_lff_launch_refuses(case):
    """In place into the buffer it reads, an output slot past the output's
    channels, another output dtype, a channel stride TMA cannot take, and
    weights wider than the buffer all raise before a launch."""
    cat, lw, lb, out, coff = _bad_lff_bf16(case)
    with pytest.raises(ValueError):
        rdb.lff_launch(cat, lw, lb, out, coff)


@pytest.mark.parametrize("case", ["in_place", "image", "slot"])
def test_lff_launch_i8_refuses(case):
    c, ccat = 16, 176
    cat = torch.zeros((1, 4, 5, 176), dtype=torch.int8)
    image = torch.zeros(r8.lff_image_size(ccat, c) + (16 if case == "image" else 0),
                        dtype=torch.int8)
    f = torch.zeros(c)
    out = cat if case == "in_place" else torch.zeros((1, 4, 5, 32), dtype=torch.int8)
    with pytest.raises(ValueError):
        r8.lff_launch_i8(cat, ccat, image, f, f, f[:1], f[:1], out, 24 if case == "slot" else 0)


# --------------------------------------------------------------------------- #
# The plain versions against the JAX package at C = 16, C + L·G = 176
# --------------------------------------------------------------------------- #
def test_bf16_stack_plain_matches_jax():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 7, 9, 16)).astype(np.float32)
    plist = [_rdb_params(rng, 16) for _ in range(3)]
    jx, tx = _bf16(x)
    jp = [[_bf16(p)[0] for p in ps] for ps in plist]
    tp = [[_bf16(p)[1] for p in ps] for ps in plist]
    ref = jax.jit(jrdb._rdb_chain_xla, compiler_options=XLA_EXACT)(jx, jp)
    got = ops.rdb_chain_apply(tx, tp)
    assert got.dtype == torch.bfloat16
    _within(got, ref.astype(jnp.float32), RDB_REL)
    # Block by block, each from the same input.
    for jps, tps in zip(jp, tp):
        ref = jax.jit(jrdb._rdb_xla, compiler_options=XLA_EXACT)(jx, jps)
        _within(rdb.rdb_plain(tx, tps), ref.astype(jnp.float32), RDB_REL)


def _jax_fusion(cat, lw, lb, c):
    """``_rdb_xla``'s fusion (rdb.py:432-436) on a whole concatenation."""
    lff = jnp.einsum("bhwk,kn->bhwn", cat.astype(jnp.float32),
                     lw.astype(jnp.float32)) + lb.astype(jnp.float32)
    return (lff * 0.2 + cat[..., :c].astype(jnp.float32)).astype(cat.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lff_plain_matches_jax(dtype):
    """The fusion alone on a wider buffer: its leading 176 channels in."""
    rng = np.random.default_rng(22)
    buf = rng.standard_normal((2, 5, 11, 184)).astype(np.float32)
    lw = (rng.standard_normal((176, 16)) / np.sqrt(176)).astype(np.float32)
    lb = (rng.standard_normal(16) * 0.1).astype(np.float32)
    if dtype == "bfloat16":
        (jcat, tcat), (jlw, tlw) = _bf16(buf), _bf16(lw)
        rel = RDB_REL
    else:
        jcat, tcat, jlw, tlw, rel = jnp.asarray(buf), torch.from_numpy(buf), jnp.asarray(lw), \
            torch.from_numpy(lw), 1e-5
    ref = jax.jit(_jax_fusion, static_argnums=3, compiler_options=XLA_EXACT)(
        jcat[..., :176], jlw, jnp.asarray(lb), 16)
    got = rdb.lff_plain(tcat, tlw, torch.from_numpy(lb))
    assert got.dtype == tcat.dtype and got.shape == (2, 5, 11, 16)
    _within(got, ref.astype(jnp.float32), rel)


@pytest.mark.parametrize("int32_taps", [False, True])
def test_int8_stack_plain_bf16_matches_jax(int32_taps):
    """bfloat16 activations in and out, both tap schemes, three blocks."""
    rng = np.random.default_rng(23)
    plist = [_rdb_params(rng, 16) for _ in range(3)]
    x = (rng.standard_normal((1, 9, 13, 16)) * 0.5).astype(np.float32)
    jx, tx = _bf16(x)
    jp = [[jnp.asarray(p) for p in ps] for ps in plist]
    scales = jax.jit(jr8.calibrate_rdb_chain)(jx.astype(jnp.float32), jp)
    jq = jax.jit(jr8.quantize_rdb_chain, static_argnames="per_channel")(
        jp, scales, per_channel=int32_taps)
    tq = tuple(([torch.from_numpy(np.array(w)) for w in wq], torch.from_numpy(np.array(dq)),
                torch.from_numpy(np.array(m))) for wq, dq, m in jq)
    ref = jax.jit(lambda v, q: jr8.rdb_chain_int8_xla(v, q, jnp.bfloat16, int32_taps=int32_taps))(
        jx, jq)
    got = ops.rdb_chain_int8_apply(tx, tq, int32_taps=int32_taps)
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    err = np.abs(got.float().numpy() - np.asarray(ref.astype(jnp.float32))).max()
    assert err <= 4 * float(jnp.max(scales)), f"max|d| {err}"


def test_int8_fusion_requantises_by_division():
    """Values on .5 steps of s_next: ``lff_plain_i8`` rounds v / s_next half
    to even, bit-equal to ``clip(rint(v / s), ±127)``, where v · (1 / s)
    rounds some of them otherwise."""
    rng = np.random.default_rng(24)
    c, ccat, s_next = 16, 176, torch.tensor(0.3)
    cat = torch.from_numpy(rng.integers(-127, 128, (1, 6, 7, ccat)).astype(np.float32))
    wl = torch.zeros((ccat, c), dtype=torch.int8)
    zero = torch.zeros(c)
    # ldq = lbias = 0: v = x · s_in with s_in = s_next / 2 lands on .5 steps.
    s_in = s_next / 2
    got = r8.lff_plain_i8(cat, wl, zero, zero, s_in, s_next)
    v = cat[..., :c] * s_in
    assert torch.equal(got, torch.clamp(torch.round(v / s_next), -127, 127).to(torch.int8))
    recip = torch.clamp(torch.round(v * (1 / s_next)), -127, 127).to(torch.int8)
    assert not torch.equal(got, recip)
