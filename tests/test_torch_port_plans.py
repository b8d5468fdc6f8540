"""The host-side plans of the port's kernel launches, as pure functions on
the CPU.

* The RDB under the TPU rounding contracts (``ops.rdb_taps``): the bf16
  kernel maps each tap to an accumulator set at compile time per contract
  family and output-row parity (``csrc/rdb_taps.cu`` ``SET_OF``, ``FOLD``).
  Each contract's (and ablation's) map must give the groups of its C table
  (``launch_table``), in order; the Python table ``FAMILIES`` must be the
  kernel source's; no two families may share groups (the kernel finds the
  family from the table).
* The depthwise layer's channel slices (``ops.conv_chain.dw_slices``): the
  fewest slices of at most 64 channels, whole 16-byte vectors, covering C;
  C ≤ 64 one slice.
* The planar d2s's row segments (``ops.pixel_shuffle.planar_segments``):
  whole 16-byte runs (bulk copies start aligned), about 16 KB a stage, a
  plane row padded by 16 bytes.

The kernels themselves run in ``tests/test_torch_port_cuda.py``, which also
holds their launch records to these plans.
"""

import importlib
import re
from pathlib import Path

import pytest
import torch

from nerve_tpu_torch.ops import conv_chain, rdb_taps

ps = importlib.import_module("nerve_tpu_torch.ops.pixel_shuffle")
CSRC = Path(conv_chain.__file__).resolve().parent.parent / "csrc"


def plan_groups(mode):
    """The groups ``accumulator_plan(mode)`` computes, per parity: the taps
    (t = 3·dy + dx) of each set, in the order the sets are added."""
    set_of, fold = rdb_taps.accumulator_plan(mode)
    return tuple([frozenset(t for t in range(9) if set_of[par][t] == s) for s in fold]
                 for par in range(2))


def table_groups(table):
    """The groups of a C table (``launch_table``'s), per parity, in walk order."""
    out = []
    for par in range(2):
        groups, cur = [], []
        for i, t in enumerate(table[9 * par:9 * par + 9]):
            cur.append(t)
            if table[18 + par] >> i & 1:
                groups.append(frozenset(cur))
                cur = []
        out.append(groups)
    return tuple(out)


def _c_array(src: str, name: str):
    """The integers of the C array ``name``'s initialiser, nested as written."""
    body = re.search(rf"{name}\[[^=]*=\s*(\{{.*?\}});", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return eval(body.replace("{", "[").replace("}", "]"))


@pytest.mark.parametrize("mode", rdb_taps.MODES)
def test_rdb_taps_plan_gives_the_table_groups(mode):
    table, _flags = rdb_taps.launch_table(mode)
    assert plan_groups(mode) == table_groups(table)


def test_rdb_taps_families_are_the_kernel_source():
    src = (CSRC / "rdb_taps.cu").read_text()
    set_of, fold, nsets = (_c_array(src, n) for n in ("SET_OF", "FOLD", "NSETS"))
    names = ("pallas_dy", "pallas_dx", "f32_taps", "s2d")  # F_DY9, F_DX9, F_ONE, F_S2D
    assert len(set_of) == len(fold) == len(nsets) == len(rdb_taps.FAMILIES) == len(names)
    for i, name in enumerate(names):
        (even, odd), order = rdb_taps.FAMILIES[name]
        assert [list(even), list(odd)] == set_of[i]
        assert list(order) == fold[i] and len(order) == nsets[i]
        # Each set is used by some tap, in both parities.
        assert all(set(par) == set(order) for par in (even, odd))
    groups = [plan_groups(m) for m in names]
    assert len({tuple(map(tuple, g)) for g in groups}) == len(names)
    # The centre tap's set is one set in both parities (the kernel's bias).
    for name in names:
        (even, odd), _ = rdb_taps.FAMILIES[name]
        assert even[4] == odd[4]


def test_rdb_taps_weight_image_at_the_n_tile():
    for cin, cout in ((12, 32), (192, 32), (384, 64), (40, 16)):
        nt = rdb_taps.n_tile(cout)
        assert nt == (16 if cout <= 16 else 32)
        img = conv_chain.pack_conv_weights(torch.zeros((3, 3, cin, cout)), nt)
        assert img.dtype == torch.bfloat16
        assert img.numel() == -(-cout // nt) * -(-cin // 16) * 9 * nt * 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_slices(dtype):
    vec = 16 // dtype.itemsize
    for c in range(1, 301):
        n, cs = conv_chain.dw_slices(c, dtype)
        assert n == -(-c // 64) and cs <= 64 and cs % vec == 0, (c, n, cs)
        assert n * cs >= c and (n - 1) * cs < c, (c, n, cs)  # no empty slice
        if c <= 64:
            assert (n, cs) == (1, -(-c // vec) * vec)
    assert conv_chain.dw_slices(200, torch.bfloat16) == (4, 56)
    assert conv_chain.dw_slices(128, torch.float32) == (2, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w,c,s", [(1920, 3, 2), (37, 3, 2), (41, 2, 3), (33, 2, 4),
                                   (1536, 4, 3), (9, 1000, 2)])
def test_planar_d2s_segments(dtype, w, c, s):
    es = dtype.itemsize
    plan = ps.planar_segments(w, c, s, dtype)
    seg, cin = plan["segment_pixels"], c * s * s
    assert seg * es % 16 == 0 and plan["plane_stride"] == seg + 16 // es
    assert plan["segments"] * seg >= w > (plan["segments"] - 1) * seg
    # About SEG_BYTES of all planes, at least one 16-byte run, at most the row.
    assert seg * cin * es <= max(ps.SEG_BYTES, 16 * cin) and seg < w + 16 // es
    assert plan["stage_bytes"] % 128 == 0 and plan["stage_bytes"] >= plan["plane_stride"] * cin * es
    # Consecutive planes start 4 banks apart (a 16-byte pad) or more.
    words = plan["plane_stride"] * es // 4
    assert words % 32 != 0
    if (w, c, s) == (1920, 3, 2):
        assert plan["stage_bytes"] <= ps.SEG_BYTES + 12 * 16 + 128
