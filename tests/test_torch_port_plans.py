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
* The float32 dense layer's plan (``ops.conv_chain.f32_plan``, the table
  and constants of ``csrc/conv_f32.cuh``) and its input route by shape
  (``f32_input_route``).

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


def _c_macro(src: str, name: str):
    """The integers of the brace initialiser that ``#define name`` stands for."""
    body = re.search(rf"#define {name}\s+((?:[^\n]*\\\n)*[^\n]*)", src).group(1)
    body = body.replace("\\\n", " ")
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


def test_f32_plan_constants_are_the_kernel_source():
    src = (CSRC / "conv_f32.cuh").read_text()
    one, three = _c_macro(src, "NT_F32_CFG")
    assert [tuple(r) for r in one] == list(conv_chain.F32_CFG[1])
    assert [tuple(r) for r in three] == list(conv_chain.F32_CFG[3])
    assert _c_macro(src, "NT_F32_CHUNK") == [conv_chain.F32_CHUNK[1], conv_chain.F32_CHUNK[3]]
    decls = " ".join(re.findall(r"^constexpr int (F32_[^;\[]*);", src, re.M))
    scalars = dict(re.findall(r"\b(F32_[A-Z_]+) = (\d+)", decls))
    assert {k: int(v) for k, v in scalars.items()} == {
        "F32_P": conv_chain.F32_P, "F32_TW": conv_chain.F32_TW,
        "F32_MAX_STAGES": conv_chain.F32_MAX_STAGES,
        "F32_MIN_RESIDENT_STAGES": conv_chain.F32_MIN_RESIDENT_STAGES,
        "F32_BAR_BYTES": conv_chain.F32_BAR_BYTES, "F32_SPLIT": conv_chain.F32_SPLIT,
        "F32_SPLIT_THREADS": conv_chain.F32_SPLIT_THREADS}
    # Every configuration's warps cover its N tile with 16-byte weight reads.
    for maxc, o, wn, wm in conv_chain.F32_CFG[1] + conv_chain.F32_CFG[3]:
        assert o % 4 == 0 and o * wn >= maxc and 32 * wn * wm <= 1024


# (cin, cout, k) -> (tile_h, n_tile, resident, stages) at 1 x 1080 x 1920:
# the serving and training sites (heads, the 64-wide layers, the RDB's
# layers and its fusion, the lightweight tail, the flow head's 2- and
# 128-channel layers, a 384-channel layer).
F32_PLANS = {
    (3, 64, 3): (8, 64, True, 4), (3, 32, 3): (8, 32, True, 4),
    (64, 64, 3): (8, 64, True, 4), (32, 12, 3): (16, 16, True, 3),
    (96, 32, 3): (8, 32, True, 4), (128, 32, 3): (8, 32, True, 4),
    (160, 32, 3): (8, 32, True, 4), (192, 32, 3): (8, 32, False, 3),
    (224, 64, 1): (16, 64, True, 4), (32, 2, 3): (32, 4, True, 4),
    (81, 128, 3): (8, 64, False, 4), (384, 64, 3): (8, 64, False, 4),
}


@pytest.mark.parametrize("cin,cout,k", list(F32_PLANS))
def test_f32_plan(cin, cout, k):
    tile_h, nt, resident, stages = F32_PLANS[cin, cout, k]
    plan = conv_chain.f32_plan(cin, cout, k)
    assert (plan["tile_h"], plan["n_tile"], plan["resident"], plan["stages"]) == (
        tile_h, nt, resident, stages), plan
    assert plan["tile_w"] == 32 and plan["n_tiles"] == -(-cout // nt)
    assert plan["split"] == 1
    assert plan["threads"] == 32 * (nt // plan["out_channels_a_thread"]) * (tile_h // 8)
    assert plan["chunks"] * plan["chunk"] >= cin > (plan["chunks"] - 1) * plan["chunk"]
    assert plan["smem_bytes"] <= conv_chain.H100_SMEM and plan["smem_bytes"] % 128 == 0
    # The output staged for TMA stores where one unit's area fits beside
    # what the layer keeps without it: not where the weights would then
    # stream (the RDB's 160-channel layer).
    assert plan["staged_store"] == ((cin, cout, k) != (160, 32, 3))
    # Resident weights only where they leave room for three stages.
    r128 = lambda n: -(-n // 128) * 128  # noqa: E731
    gc = conv_chain.F32_GROUP[k]
    wbytes = -(-(-(-cin // gc) * gc * k * k * nt * 4) // 1024) * 1024
    in_bytes = plan["chunk"] // gc * r128((tile_h + k - 1) * (32 + k - 1) * gc * 4)
    assert plan["resident"] == (plan["n_tiles"] == 1 and wbytes + 3 * in_bytes
                                <= conv_chain.H100_SMEM - conv_chain.F32_BAR_BYTES)
    # A smaller device keeps to its shared memory and keeps weights resident
    # only where the larger one does.
    small = conv_chain.f32_plan(cin, cout, k, smem=120 * 1024)
    assert small["smem_bytes"] <= 120 * 1024
    assert plan["resident"] or not small["resident"]


# The meta step's small grids take a narrower N tile while that gives more
# tiles, then split each K chunk over two warp sets in blocks of 128
# threads: (cin, cout, k, b, h, w) -> (tile_h, n_tile, tiles, split).
F32_SMALL_GRIDS = {
    (64, 64, 3, 4, 64, 64): (8, 32, 128, 2), (3, 64, 3, 12, 64, 64): (8, 32, 384, 1),
    (224, 64, 1, 4, 64, 64): (8, 32, 128, 2), (160, 32, 3, 4, 64, 64): (8, 32, 64, 2),
    (3, 32, 3, 1, 64, 64): (8, 32, 16, 1), (64, 64, 3, 1, 1080, 1920): (8, 64, 8100, 1),
}


@pytest.mark.parametrize("shape", list(F32_SMALL_GRIDS))
def test_f32_plan_small_grids(shape):
    cin, cout, k, b, h, w = shape
    plan = conv_chain.f32_plan(cin, cout, k, b, h, w)
    assert (plan["tile_h"], plan["n_tile"], plan["tiles"], plan["split"]) == F32_SMALL_GRIDS[
        shape], plan
    assert plan["threads"] == 32 * plan["n_tile"] // plan["out_channels_a_thread"] * (
        plan["tile_h"] // 8) * plan["split"]
    base = next(i for i, c in enumerate(conv_chain.F32_CFG[k]) if cout <= c[0])
    assert plan["config"] == base or plan["tiles"] > conv_chain.f32_tiles(k, base, cout, b, h, w)


def test_f32_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="does not fit"):
        conv_chain.f32_plan(64, 64, 3, smem=30 * 1024)
    for bad in ((0, 64, 3), (64, 0, 3), (64, 64, 5)):
        with pytest.raises(ValueError, match="no float32 plan"):
            conv_chain.f32_plan(*bad)


def _nhwc(*cs, offset=0):
    out = []
    for c in cs:
        base = torch.zeros(2 * 5 * 7 * c + offset)
        out.append(base[offset:].view(2, 5, 7, c))
    return out


# parts, cin -> route
F32_ROUTES = {
    "one_64": (_nhwc(64), 64, "tma"),
    "leading_cin": (_nhwc(224), 192, "tma"),
    "head_3": (_nhwc(3), 3, "async"),
    "flow_81": (_nhwc(81), 81, "async"),
    "misaligned": (_nhwc(64, offset=1), 64, "async"),
    "three_parts": (_nhwc(64, 64, 64), 192, "tma"),
    "two_parts_of_3": (_nhwc(3, 3), 6, "async"),
    "unequal_parts": (_nhwc(4, 8), 12, "copy"),
    "four_parts": (_nhwc(4, 4, 4, 4), 16, "copy"),
    "not_contiguous": ([torch.zeros(2, 7, 5, 8).transpose(1, 2)], 8, "copy"),
    # A 1x1 layer stages 16-channel boxes: parts of 4 or 8 channels take cp.async.
    "1x1_parts_of_8": (_nhwc(8, 8), 16, "async", 1),
    "1x1_parts_of_16": (_nhwc(16, 16, 16), 48, "tma", 1),
    "1x1_one_12": (_nhwc(12), 12, "tma", 1),
}


@pytest.mark.parametrize("case", list(F32_ROUTES))
def test_f32_input_route(case):
    xs, cin, route, *k = F32_ROUTES[case]
    assert conv_chain.f32_input_route(xs, cin, *k) == route


def test_f32_input_route_refuses():
    with pytest.raises(ValueError, match="reads 65 channels"):
        conv_chain.f32_input_route(_nhwc(64), 65)
    with pytest.raises(ValueError, match="reads 12 channels"):
        conv_chain.f32_input_route(_nhwc(8, 8), 12)
    with pytest.raises(ValueError, match="NHWC tensors of one size"):
        conv_chain.f32_input_route([torch.zeros(2, 5, 7, 4), torch.zeros(2, 5, 6, 4)], 8)
