"""Build and load the CUDA sources under ``csrc/`` with ``nvcc``.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>-<digest>.so`` at the
repository root (the digest covers the source, the headers it includes
and its flags, so an edited source never loads a stale library),
compiled at first use for Hopper (``sm_90a``) with a plain C interface
and loaded with ctypes.  Flags are per source: the metering kernels
build with ``--fmad=false`` (their carbon lanes round step by step like
the plain versions); the attention and RG-LRU kernels keep fused
multiply-adds.
All missing libraries compile in parallel, one ``nvcc`` per source.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict

_HERE = pathlib.Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD = _HERE.parents[2] / "build"
_BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3")
_LIB_FLAGS = ("-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
# per source: (nvcc flags, headers of csrc/ it includes)
_SOURCES = {
    "segment_trapz": (_BASE_FLAGS + ("--fmad=false",) + _LIB_FLAGS, ()),
    "flash_attention": (_BASE_FLAGS + _LIB_FLAGS,
                        ("attention_common.cuh",)),
    "flash_attention_sm90": (_BASE_FLAGS + _LIB_FLAGS, ()),
    "decode_attention": (_BASE_FLAGS + _LIB_FLAGS,
                         ("attention_common.cuh",)),
    "rglru_scan": (_BASE_FLAGS + _LIB_FLAGS, ()),
}
SOURCES = tuple(_SOURCES)

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    the toolkit's default install prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def lib_path(name: str) -> pathlib.Path:
    flags, headers = _SOURCES[name]
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(flags).encode())
    for hdr in headers:
        h.update((CSRC / hdr).read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, float]:
    """Compile every source whose library is missing, all at once.
    Returns per-source wall seconds (0.0 for a library already built)
    and writes each compiler log (``-Xptxas -v``: registers, shared
    memory, spills) next to its library as ``.log``.  Raises with the
    compiler's output if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *_SOURCES[name][0], "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    secs = {name: 0.0 for name in SOURCES}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return secs


def loaded() -> int:
    """How many of the libraries this process has loaded."""
    return len(_libs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if missing."""
    lib = _libs.get(name)
    if lib is None:
        if not lib_path(name).exists():
            build_all()
        lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
    return lib
