"""The int8 RDB chain's schemes beside the bf16 chain:
``python -m nerve_tpu_torch.diag.rdb_int8 [--device cpu] [--small]``.

Counterpart of ``scripts/diag_rdb_int8.py`` (its ``--per-channel`` and
``--dx-major`` runs, here all four in one): per-column scales with the taps
dequantised dy outer (the serving default) or dx outer (``DX_MAJOR_INT8``),
and per-channel scales with the nine taps summed in int32 (``int32_taps``,
the scheme of ``PER_CHANNEL_INT8``), dy or dx outer. Each scheme is first
held against its plain version on a small shape, a block with float32
output at 1e-4 and the chain within 4 × its largest activation scale, and
the int8 chain's error against the float32 chain is printed; then each is
timed at 1080p, 64 features, 8 blocks in bfloat16, beside
``ops.rdb_chain_apply``.
"""

from __future__ import annotations

import torch

from nerve_tpu_torch import ops
from nerve_tpu_torch.diag import _common
from nerve_tpu_torch.ops import rdb, rdb_int8

# name -> (per-channel quantisation and int32 taps, dx outer)
SCHEMES = {
    "per-column": (False, False),
    "per-column dx-major": (False, True),
    "per-channel int32_taps": (True, False),
    "per-channel dx-major": (True, True),
}


def chains(g, c, blocks, dev):
    return [_common.rdb_params(g, c, dev, bias_std=0.02) for _ in range(blocks)]


def check(dev, g, c: int = 64, blocks: int = 2, shape=(1, 24, 70)) -> dict:
    """Each scheme's kernel against its plain version at a small shape:
    {scheme: (max|Δ| block f32, max|Δ| chain, chain limit, rel. error vs f32)}."""
    plist = chains(g, c, blocks, dev)
    x = torch.randn((*shape, c), generator=g).to(dev) * 0.5
    scales = rdb_int8.calibrate_rdb_chain(x, plist)
    fref = rdb.rdb_chain_plain(x, plist)
    out = {}
    for name, (per_channel, dx) in SCHEMES.items():
        q = rdb_int8.quantize_rdb_chain(plist, scales, per_channel=per_channel)
        blk = max(_common.max_abs(
            ops.rdb_chain_int8_apply(x, (b,), torch.float32, per_channel, dx),
            rdb_int8.rdb_chain_int8_plain(x, (b,), torch.float32, per_channel, dx)) for b in q)
        got = ops.rdb_chain_int8_apply(x.bfloat16(), q, None, per_channel, dx)
        ref = rdb_int8.rdb_chain_int8_plain(x.bfloat16(), q, None, per_channel, dx)
        limit = 4 * scales.max().item()
        err = _common.max_abs(got, ref)
        rel = _common.max_abs(got, fref) / fref.abs().max().item()
        print(f"check {name:24s} block f32 max|d| {blk:.3e} (limit 1e-4), chain max|d| "
              f"{err:.3e} (limit {limit:.3e}); int8 vs f32 chain rel. max err {rel:.4f}",
              flush=True)
        if not (blk <= 1e-4 and err <= limit):
            raise AssertionError(f"int8 RDB {name}: the kernel disagrees with its plain version")
        out[name] = (blk, err, limit, rel)
    return out


def timings(dev, g, c: int, blocks: int, h: int, w: int, reps: int) -> dict:
    """{case: ms} of each scheme's chain and of the bf16 chain on a (1, h, w, c)
    bfloat16 input."""
    plist = chains(g, c, blocks, dev)
    xcal = torch.randn((1, min(h, 128), min(w, 256), c), generator=g).to(dev) * 0.5
    scales = rdb_int8.calibrate_rdb_chain(xcal, plist)
    x = (torch.randn((1, h, w, c), generator=g) * 0.5).to(dev, torch.bfloat16)
    pb = [[p.bfloat16() for p in ps] for ps in plist]
    out = {"bf16 rdb_chain_apply": _common.median_ms(lambda: ops.rdb_chain_apply(x, pb), dev,
                                                      reps)}
    for name, (per_channel, dx) in SCHEMES.items():
        q = rdb_int8.quantize_rdb_chain(plist, scales, per_channel=per_channel)
        pq = rdb_int8.packed_rdb_chain(q, per_channel)  # packed once, as a model keeps it
        out[name] = _common.median_ms(
            lambda q=q, pc=per_channel, dx=dx, pq=pq: ops.rdb_chain_int8_apply(x, q, None, pc,
                                                                               dx, pq),
            dev, reps)
    return out


def main(argv=None) -> dict:
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("--blocks", type=int, default=8)
    args = p.parse_args(argv)
    dev = _common.device_of(args)
    g = torch.Generator().manual_seed(0)
    c, h, w = (16, 12, 20) if args.small else (64, 1080, 1920)
    check(dev, g, c, 2, (1, 9, 21) if args.small else (1, 64, 256))
    blocks = 2 if args.small else args.blocks
    times = timings(dev, g, c, blocks, h, w, args.reps)
    bf16 = times["bf16 rdb_chain_apply"]
    for name, ms in times.items():
        print(f"time {name:24s} {ms:9.3f} ms ({blocks} blocks at {h}x{w}x{c}; "
              f"{ms / blocks:.3f} ms/block; {bf16 / ms:.2f}x the bf16 chain)", flush=True)
    return times


if __name__ == "__main__":
    main()
