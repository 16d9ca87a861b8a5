"""Build and load the CUDA sources under ``csrc/`` with ``nvcc``.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>-<digest>.so`` at the
repository root (the digest covers the source, the headers it includes
and its flags, so an edited source never loads a stale library),
compiled at first use for Hopper (``sm_90a``) with a plain C interface
and loaded with ctypes.  Flags are per source: the metering kernels
build with ``--fmad=false`` (their carbon lanes round step by step like
the plain versions); the attention and RG-LRU kernels keep fused
multiply-adds.
All missing libraries compile in parallel, one ``nvcc`` per source;
``start_all`` starts them and ``finish`` waits for one, so a caller may
go on while a slow source builds (``load`` waits for its own).
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Any, Dict, Tuple

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
                        ("attention_common.cuh", "softcap.cuh")),
    "flash_attention_sm90": (_BASE_FLAGS + _LIB_FLAGS, ("softcap.cuh",)),
    "flash_attention_f32": (_BASE_FLAGS + _LIB_FLAGS,
                            ("attention_tf32.cuh", "softcap.cuh")),
    "flash_attention_f32_bwd": (_BASE_FLAGS + _LIB_FLAGS,
                                ("attention_tf32.cuh", "softcap.cuh")),
    "decode_attention": (_BASE_FLAGS + _LIB_FLAGS,
                         ("attention_common.cuh", "softcap.cuh")),
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


# source -> (its nvcc process, the thread collecting its output, what the
# thread collected, temporary output, library) while it builds
_pending: Dict[str, Tuple[subprocess.Popen, threading.Thread, Dict[str, Any],
                          pathlib.Path, pathlib.Path]] = {}
_t0 = 0.0


def _collect(proc: subprocess.Popen, box: Dict[str, Any]) -> None:
    box["log"], _ = proc.communicate()
    box["secs"] = time.perf_counter() - _t0


def start_all() -> None:
    """Start one ``nvcc`` for every source whose library is missing and
    is not building already, all at once, and return without waiting
    (``finish`` waits for one); a thread a source collects its
    compiler's output and the time it ended."""
    global _t0
    BUILD.mkdir(parents=True, exist_ok=True)
    if not _pending:
        _t0 = time.perf_counter()
    for name in SOURCES:
        out = lib_path(name)
        if out.exists() or name in _pending:
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *_SOURCES[name][0], "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        box: Dict[str, Any] = {}
        th = threading.Thread(target=_collect, args=(proc, box), daemon=True)
        th.start()
        _pending[name] = (proc, th, box, tmp, out)


def finish(name: str) -> float:
    """Wait for ``name``'s build if it is running: the seconds from the
    builds' start to its compiler's end (0.0 if none ran), its compiler
    log (``-Xptxas -v``: registers, shared memory, spills) written next
    to its library as ``.log``.  Raises with the compiler's output if it
    failed."""
    if name not in _pending:
        return 0.0
    proc, th, box, tmp, out = _pending.pop(name)
    th.join()
    out.with_suffix(".log").write_text(box["log"])
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"CUDA kernel build failed: {name}.cu (nvcc exit "
                           f"{proc.returncode}):\n{box['log']}")
    os.replace(tmp, out)
    return box["secs"]


def stop_all() -> None:
    """End every build still running (its library is not written)."""
    for name in list(_pending):
        proc, th, _, tmp, _ = _pending.pop(name)
        proc.kill()
        th.join()
        tmp.unlink(missing_ok=True)


def loaded() -> int:
    """How many of the libraries this process has loaded."""
    return len(_libs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if missing (its
    build waited for if it is running)."""
    lib = _libs.get(name)
    if lib is None:
        if not lib_path(name).exists():
            start_all()
            finish(name)
        lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
    return lib
