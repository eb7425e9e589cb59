"""Build and load the port's kernel library (egress and flash attention).

The CUDA sources under ``csrc/`` are compiled at first use with ``nvcc``
for ``sm_90a`` — one ``nvcc`` per ``.cu`` file, all started together, then
one link into a shared library with a plain C interface — and loaded with
``ctypes``.  The library lands in ``build/repro_torch_kernels/<hash>/`` at
the root of the checkout, keyed by a hash of the sources, so an edited
kernel is rebuilt and an unchanged one is loaded as it is.  A failed build
raises with nvcc's own error output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
LIB_NAME = "libkernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I32, _I64, _U32, _F32 = (ctypes.c_void_p, ctypes.c_int32,
                              ctypes.c_int64, ctypes.c_uint32, ctypes.c_float)
# C entry points: (name, argtypes); each returns cudaGetLastError()
SIGNATURES = {
    "memcrypt_launch": [_P, _P, _I64, _U32, _U32, _U32, _P],
    "permcheck_launch": [_P, _I64, _P, _P, _P, _I64, _P, _I32, _I32, _I32,
                         _P, _P, _P],
    "checked_memcrypt_launch": [_P, _P, _I64, _P, _P, _P, _I64, _P, _I32,
                                _I32, _I32, _U32, _U32, _U32, _P, _P, _P],
    "fabric_egress_launch": [_P, _P, _I64, _I64, _I64, _P, _P, _P, _P,
                             _I64, _P, _I32, _I32, _U32, _U32, _P, _P, _P],
    # q, k, v, o, dtype, (b, h, hkv, sq, sk, dh), 12 strides, scale,
    # causal, window, workspace, (splits, chunk, k_begin, k_end), stream
    "flash_attention_launch": [_P, _P, _P, _P, _I32] + [_I64] * 18
    + [_F32, _I32, _I32, _P, _I32, _I32, _I32, _I32, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    """Every file the library is built from, in a fixed order."""
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "from source on a machine with the CUDA toolkit")
    return found


def _build(out_dir: Path) -> None:
    nvcc = nvcc_path()
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=".build-", dir=out_dir.parent))
    try:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = tmp / (src.stem + ".o")
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
                 str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                               + "\n".join(log))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / LIB_NAME),
             *sorted(str(o) for o in tmp.glob("*.o"))],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        (tmp / "nvcc.log").write_text("\n".join(log))
        try:
            tmp.rename(out_dir)   # atomic: a concurrent build may win
        except OSError:
            if not (out_dir / LIB_NAME).exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            out_dir = BUILD_ROOT / source_hash()
            if not (out_dir / LIB_NAME).exists():
                _build(out_dir)
            lib = ctypes.CDLL(str(out_dir / LIB_NAME))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def build_log() -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) of
    the library ``library()`` loads."""
    return (BUILD_ROOT / source_hash() / "nvcc.log").read_text()


def launch(name: str, *args) -> None:
    """Call one C entry point; raise on a non-zero cudaError_t."""
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError_t {err}")
