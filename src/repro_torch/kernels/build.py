"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface and loaded with
``ctypes``.  The build happens at the first launch, never at import, goes
into ``build/`` at the root of the checkout (or ``$REPRO_TORCH_BUILD_DIR``)
and is keyed on a hash of the sources, so an edited file rebuilds.  Every
source is compiled by its own ``nvcc`` process, all started together.  A
failed build raises; nothing carries on without the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
#: seconds the last real build took (0.0 when the library was found built)
last_build_seconds = 0.0


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_root() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home:
            cands.append(os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the port's "
        "CUDA kernels cannot be built on this machine")


def build_dir() -> Path:
    """Where this source tree's library and ``nvcc.log`` (with ptxas's
    registers and spill bytes of every kernel, ``-Xptxas -v``) go."""
    return build_root() / f"repro_torch_kernels-{source_hash()}"


def build_library() -> Path:
    """Compile ``csrc/*.cu`` (one nvcc per source, in parallel), link them
    into ``libreprotorch_kernels.so`` and return its path."""
    global last_build_seconds
    out_dir = build_dir()
    lib = out_dir / "libreprotorch_kernels.so"
    if lib.exists():
        return lib
    t0 = time.perf_counter()
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources():
        obj = out_dir / (src.stem + f".{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for src, obj, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    (out_dir / "nvcc.log").write_text("\n".join(log))
    if failed:
        print("\n".join(log), flush=True)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}; see the log above")
    tmp = out_dir / f"lib.{os.getpid()}.so"
    subprocess.run([nvcc, "-shared", "-o", str(tmp),
                    *[str(o) for _, o, _ in procs]], check=True)
    os.replace(tmp, lib)
    for _, obj, _ in procs:
        obj.unlink()
    last_build_seconds = time.perf_counter() - t0
    return lib


def _bind(lib: ctypes.CDLL):
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.paged_decode_attention.restype = i
    lib.paged_decode_attention.argtypes = [
        p, p, p, p, p, p, p, p,            # q k v tables lengths ks vs out
        p, p, p,                           # workspace: acc m l
        i, i, i, i, i, i, i,               # B Hq Hkv D NB block_size n_blk
        i, i,                              # keys_per_split splits
        i64, i64, i64,                     # strides
        i, i, p]                           # dtypes, stream
    lib.paged_chunked_prefill_attention.restype = i
    lib.paged_chunked_prefill_attention.argtypes = [
        p, p, p, p, p, p, p, p, p,         # q k v tables start valid ks vs out
        i, i, i, i, i, i, i, i,            # B Tq Hq Hkv D NB block_size n_blk
        i64, i64, i64,
        i, i, p]
    lib.dense_decode_attention.restype = i
    lib.dense_decode_attention.argtypes = [
        p, p, p, p, p,                     # q k v lengths out
        p, p, p,                           # workspace: acc m l
        i, i, i, i, i,                     # B Hq Hkv D S
        i, i,                              # keys_per_split splits
        i64, i64, i64,                     # strides (row, position, head)
        i, i, p]                           # dtypes, stream
    lib.dense_chunked_prefill_attention.restype = i
    lib.dense_chunked_prefill_attention.argtypes = [
        p, p, p, p, p,                     # q k v prefix out
        i, i, i, i, i, i,                  # B Tq Hq Hkv D S
        i64, i64, i64,
        i, i, p]
    lib.ssd_scan.restype = i
    lib.ssd_scan.argtypes = [
        p, p, p, p, p, p, p, p,            # x dt A B C s0 y sfin
        i, i, i, i, i, i,                  # b T H G P N
        i64, i64, i64, i64, i64, i64, i64,  # strides: x, dt, B/C (batch,
                                           # token), s0 (batch)
        i, p]                              # x dtype, stream


def load_library() -> ctypes.CDLL:
    """The built library, building it first if this process has not."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        _bind(lib)
        _lib = lib
    return _lib
