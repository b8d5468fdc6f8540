"""Build the CUDA kernels of ``nerve_tpu_torch/csrc`` and bind them with ctypes.

One ``nvcc -c`` per ``csrc/*.cu``, all started together, compiles each
source for Hopper (``sm_90a``); one more ``nvcc`` links the objects into
one shared library with a plain C interface (``csrc/nerve_tpu_torch.h``).
The library lands in ``build/nerve_tpu_torch/`` under the repository root,
named by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads at once. Nothing builds at import: the first kernel
launch builds. A missing ``nvcc`` or a failed build raises with the
compiler's message; there is no fallback.

``launch`` is every kernel's way onto the card, so its host cost is paid
per launch: each entry point is bound once, with its argument types, when
the library loads; a loaded library is read without a lock; the stream is
the raw handle of the device's current stream (no ``Stream`` object); and
the current device is switched only when the tensors lie on another one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nerve_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> (restype, argtypes); see csrc/nerve_tpu_torch.h.
SIGNATURES = {
    "nt_d2s_packed": (_I, (_P, _P, _I, _I, _I, _I, _I, _I, _P)),
    "nt_d2s_packed_planar": (_I, (_P, _P, _I, _I, _I, _I, _I, _I, _P)),
    "nt_rdb_taps_conv": (_I, (_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P)),
    "nt_probe_scale2": (_I, (_P, _P, _I, _P)),
    "nt_correlation": (_I, (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P)),
    "nt_conv2d": (_I, (_P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       _P)),
    "nt_dwconv3": (_I, (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)),
    "nt_planar_chain": (_I, (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)),
    "nt_rdb_lff": (_I, (_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P)),
    "nt_conv2d_i8": (_I, (_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P)),
    "nt_rdb_lff_i8": (_I, (_P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _P)),
    "nt_quantize_i8": (_I, (_P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P)),
    "nt_error_string": (ctypes.c_char_p, (_I,)),
}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_entry: dict = {}  # name -> the bound C function, filled once when the library loads
_raw_stream = _current_device = None  # torch._C's raw-stream and current-device queries


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): cannot build the CUDA kernels")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.h")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libnerve_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
            for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    log, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out = proc.communicate()[0]
        log += [" ".join(cmd), out]
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} (exit {proc.returncode}):\n{out}")
    if not failed:
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log += [" ".join(link), proc.stdout]
        if proc.returncode != 0:
            failed.append(f"link (exit {proc.returncode}):\n{proc.stdout}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    lib.with_suffix(".log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib, _raw_stream, _current_device
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            bound = {}
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
                bound[name] = fn
            # launch() reads _entry without the lock: publish the entry
            # points only once what they need is set.
            _raw_stream = torch._C._cuda_getCurrentRawStream
            _current_device = torch._C._cuda_getDevice
            _entry.update(bound)
            _lib = lib
    return _lib


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"the CUDA kernels take float32, bfloat16 or int8, got {t.dtype}") from None


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s current stream; raise on error.

    ``args`` are the entry point's arguments without the trailing stream.
    """
    fn = _entry.get(name)
    if fn is None:
        library()
        fn = _entry[name]
    index = device.index
    current = _current_device()
    if index is None or index == current:
        err = fn(*args, _raw_stream(current))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _raw_stream(index))
    if err != 0:
        msg = _entry["nt_error_string"](err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
