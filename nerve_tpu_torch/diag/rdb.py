"""Cost attribution of one residual dense block:
``python -m nerve_tpu_torch.diag.rdb [--profile DIR] [--device cpu] [--small]``.

Counterpart of ``scripts/diag_rdb.py``. One block at 1080p × 64 features in
bfloat16 (seeded weights and non-zero biases) runs through

* ``ops.rdb_chain_apply``: the serving RDB (``nt_conv2d`` per dense layer,
  ``_rdb_xla``'s rounding, then ``nt_rdb_lff``);
* ``ops.rdb_taps_apply`` under each rounding contract of
  ``ops.rdb_taps.CONTRACTS`` (the TPU kernels' own numerics), each held
  against its plain version (max|Δ|, relative to max|plain|, limit 1.56e-2,
  the JAX kernel gate's level for bf16);
* the ablations, each on ``pallas_dx``'s walk of nine single-tap groups:
  ``nolff`` (no fusion), ``noshift`` (every group rounded, only the centre
  tap's kept) and, on the card, ``matonly`` (each group folded unrounded,
  nothing stored).

The table attributes the ``pallas_dx`` block's time: fusion = pallas_dx −
nolff, the tap adds = pallas_dx − noshift, bias, group rounding, relu and
the layers' stores = noshift − matonly, the products with the group folds
and the fusion = matonly. Nine groups against one = pallas_dx − f32_taps
(a different walk: the one comparison that does not share it).

On the card it also prints the bf16 layer's launch record for each
contract at the block's widest layer (grid, threads, shared memory,
registers and spills, tiles, N tile, stages, resident weights, accumulator
sets; ``ops.rdb_taps.launch_record``, where the package has one) and
ptxas's usage of the tap kernels from the build log; with ``--profile
DIR`` each case's device time per block and launches per call of the tap
kernels under ``torch.profiler`` (five dense layers and one fusion a
block). It measures the ``nerve_tpu_torch`` that is first on the path and
prints its location first; the last line is one JSON object.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

import nerve_tpu_torch
from nerve_tpu_torch import ops
from nerve_tpu_torch.diag import _common
from nerve_tpu_torch.ops import rdb_taps

REL_LIMIT = 1.56e-2  # bf16; float32 holds 1e-4


def attribution(x: torch.Tensor, params, reps: int, check: bool = True) -> list:
    """[(case, ms, max|Δ| vs plain or None)] for one block on ``x``."""
    dev = x.device
    limit = REL_LIMIT if x.dtype == torch.bfloat16 else 1e-4
    rows = [("rdb_chain_apply", _common.median_ms(lambda: ops.rdb_chain_apply(x, [params]),
                                                  dev, reps), None)]
    # matonly has no plain version, so it runs on the card only.
    ablations = ("nolff", "noshift", "matonly") if dev.type == "cuda" else ("nolff", "noshift")
    for mode in (*rdb_taps.CONTRACTS, *ablations):
        err = None
        if check and mode != "matonly":
            ref = rdb_taps.rdb_taps_plain(x, params, mode)
            err = _common.max_abs(ops.rdb_taps_apply(x, params, mode), ref)
            if not err <= limit * ref.float().abs().max().item():
                raise AssertionError(f"rdb_taps {mode}: max|d| {err} against its plain version")
            del ref
        rows.append((mode, _common.median_ms(
            lambda mode=mode: ops.rdb_taps_apply(x, params, mode), dev, reps), err))
    return rows


def report(rows, label: str) -> dict:
    """Print the table and the attribution; {case: ms}."""
    ms = {name: t for name, t, _e in rows}
    for name, t, err in rows:
        e = "" if err is None else f"  max|d| vs plain {err:.3e}"
        print(f"rdb {name:16s} {t:9.3f} ms  ({label}){e}", flush=True)
    full = ms["pallas_dx"]
    parts = {"fusion (pallas_dx - nolff)": full - ms["nolff"],
             "tap adds (pallas_dx - noshift)": full - ms["noshift"]}
    if "matonly" in ms:
        parts.update({"bias, rounding, relu, stores (noshift - matonly)":
                      ms["noshift"] - ms["matonly"],
                      "products, group folds, fusion (matonly)": ms["matonly"]})
    parts["nine groups against one (pallas_dx - f32_taps)"] = full - ms["f32_taps"]
    for name, t in parts.items():
        print(f"rdb attribution {name:52s} {t:9.3f} ms  {t / full:7.1%} of pallas_dx",
              flush=True)
    return ms


def launch_records(x: torch.Tensor, params) -> dict:
    """{contract: the bf16 launch record of the block's widest dense layer}."""
    w = params[-4]  # the last dense layer's weight (3, 3, cin, G)
    return {mode: rdb_taps.launch_record(x, w.shape[2], w.shape[3], mode)
            for mode in rdb_taps.CONTRACTS}


def main(argv=None) -> dict:
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("--profile", metavar="DIR",
                   help="also trace each case's calls, writing the traces into DIR")
    args = p.parse_args(argv)
    dev = _common.device_of(args)
    print(f"package {nerve_tpu_torch.__file__}", flush=True)
    g = torch.Generator().manual_seed(0)
    c, h, w = (16, 10, 21) if args.small else (64, 1080, 1920)
    params = _common.rdb_params(g, c, dev, torch.bfloat16)
    x = torch.randn((1, h, w, c), generator=g).to(dev, torch.bfloat16)
    label = f"one block, {h}x{w}x{c} bf16"
    result = {"ms": report(attribution(x, params, args.reps), label)}
    if dev.type == "cuda":
        if hasattr(rdb_taps, "launch_record"):
            result["launch"] = launch_records(x, params)
            for mode, rec in result["launch"].items():
                print(f"launch rdb_taps {mode} (cin {params[-4].shape[2]}): {json.dumps(rec)}",
                      flush=True)
        result["ptxas"] = _common.ptxas_usage("taps_")
        for line in result["ptxas"]:
            print(f"ptxas {line}", flush=True)
    if args.profile:
        if dev.type != "cuda":
            raise SystemExit("--profile traces the card: run it with --device cuda")
        modes = (*rdb_taps.CONTRACTS, "noshift", "nolff", "matonly")
        result["profile"] = {mode: _common.profile_calls(
            lambda mode=mode: ops.rdb_taps_apply(x, params, mode), Path(args.profile),
            f"rdb_taps_{mode}", ("taps_",)) for mode in modes}
    print(json.dumps(result))
    return result["ms"]


if __name__ == "__main__":
    main()
