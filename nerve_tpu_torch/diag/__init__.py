"""Diagnostic entry points of the port, the counterparts of the JAX
package's hardware harnesses under ``scripts/``:

* ``python -m nerve_tpu_torch.diag.probe [--delay N]``: the device-health
  probe (``scripts/tpu_probe.py``);
* ``python -m nerve_tpu_torch.diag.rdb_int8``: the int8 RDB chain's four
  schemes beside the bf16 chain (``scripts/diag_rdb_int8.py``);
* ``python -m nerve_tpu_torch.diag.rdb``: the RDB's cost attribution under
  the TPU kernels' rounding contracts and ablations (``scripts/diag_rdb.py``);
* ``python -m nerve_tpu_torch.diag.rdb_s2d``: the s2d contract beside
  ``pallas_dx`` (``scripts/diag_rdb_s2d.py``);
* ``python -m nerve_tpu_torch.diag.d2s``: the packed depth-to-space
  candidates at 1080p → 2160p (``scripts/diag_d2s.py``).

Each runs on the card unless given ``--device cpu`` (``--small`` shrinks
the shapes for a CPU run). Each first holds its kernels against their plain
versions at a small shape, then times them.
"""
