"""The port's multi-device dry run on the CPU: ``python -m
nerve_tpu_torch.parallel.dryrun --world 4 --backend gloo --device cpu`` (the
twin of ``__graft_entry__.dryrun_multichip``) finishes and prints its OK
line, each of its cases run: the data-parallel step, height-sharded SR, the
data × model gradient, the full model's interior exactness over slabs of 68
rows and the lightweight planar output. Also the dry run refusing the
card without one, and ``diag.spatial`` on one gloo rank."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_dryrun_four_gloo_ranks_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "nerve_tpu_torch.parallel.dryrun", "--world", "4",
         "--backend", "gloo", "--device", "cpu", "--budget", "10", "--timeout", "240"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith("nerve_tpu_torch dryrun(4, gloo, cpu) OK: dp loss="), line
    assert "data×model grad loss=" in line and "skipped" not in line, line
    assert "full-model spatial exactness max|d|" in line and "at 272x" in line, line
    assert "fedavg waits for the federated slice" in line


def test_dryrun_refuses_the_card_without_one():
    """No card: the CUDA dry run exits with a message, never on the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", "nerve_tpu_torch.parallel.dryrun", "--world", "2",
         "--backend", "nccl", "--device", "cuda"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_diag_spatial_on_the_cpu():
    """``python -m nerve_tpu_torch.diag.spatial --device cpu --small``: one
    gloo rank; the sharded call's parts and the data-parallel step's, 6
    BatchNorm statistics all-reduces a step (the flagship body's 3 live
    BatchNorms, a mean and a variance each)."""
    proc = subprocess.run(
        [sys.executable, "-m", "nerve_tpu_torch.diag.spatial", "--device", "cpu", "--small",
         "--reps", "1"], capture_output=True, text=True, cwd=REPO, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["sr"]["extended_rows"] == res["sr"]["rows"] + 2 * res["sr"]["halo"]
    assert res["step"]["stat_all_reduces_per_step"] == 6
    assert all(v > 0 for v in (res["sr"]["sharded_ms"], res["step"]["data_parallel_step_ms"]))
