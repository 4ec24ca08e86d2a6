"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, bound with ``ctypes``.

Each ``csrc/<name>.cu`` compiles to its own
``build/repro_torch_kernels/<name>-<hash>.so`` under the repository root,
keyed by a hash of the sources, so an edited kernel rebuilds and an
unchanged one is reused.  All missing libraries compile in parallel, one
``nvcc`` per source.  Nothing here runs at import: the first call of a
kernel wrapper builds and loads its library.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

_FLASH = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
          _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _P)

#: C signature of every entry point, by source name; a source with more
#: than one entry point lists the others in EXTRA_ENTRIES.
SIGNATURES: Dict[str, tuple] = {
    # q_dtype, kv_dtype, q, k, v, ks, vs, page_table, lengths, out,
    # A, H, KVH, d, page_size, n_table, 6 strides, part, tickets, splits,
    # chunk, window, stream
    "paged_decode_attention": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I,
                               _LL, _LL, _LL, _LL, _LL, _LL,
                               _P, _P, _I, _I, _I, _P),
    # q_dtype, kv_dtype, q, k, v, lengths, out, B, H, KVH, d,
    # 3 cache strides, part, tickets, splits, chunk, window, starts, lse,
    # out32, stream
    "decode_attention": (_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _LL, _LL, _LL, _P, _P, _I, _I, _I, _P, _P, _P,
                         _P),
    # dtype, q, k, v, out, B, Sq, Skv, H, KVH, d, causal, window,
    # 3 strides each of q, k/v and out, stream (the CUDA-core route)
    "flash_attention": (_I,) + _FLASH,
    # a (M, K), bt (N, K) (both K-major e4m3, K a multiple of 16), a_scale,
    # b_scale, out, M, N, K, bm, bn, stream
    "fp8_matmul": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}

#: Further entry points of a source: name -> C signature.
EXTRA_ENTRIES: Dict[str, Dict[str, tuple]] = {
    # the tensor-core route: flash_attention's arguments without dtype
    "flash_attention": {"flash_attention_tc": _FLASH},
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                       "machine with the CUDA toolkit (PATH or "
                       "/usr/local/cuda/bin)")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _log_path(name: str) -> Path:
    return _library_path(name).with_suffix(".log")


def build_all() -> Dict[str, str]:
    """Compile every source whose library (or its compiler report) is
    missing, all ``nvcc`` processes started together.  Returns every
    source's compiler output (``-Xptxas=-v`` register, spill and
    shared-memory report), kept beside its library, so a library built by
    an earlier run reports the same as a fresh one.

    Raises:
      RuntimeError: no ``nvcc``, or a compile failed (its stderr is in
          the message)."""
    todo = {name: _library_path(name) for name in SIGNATURES}
    todo = {n: p for n, p in todo.items()
            if not (p.exists() and _log_path(n).exists())}
    if not todo:
        return {n: _log_path(n).read_text() for n in SIGNATURES}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{logs[name]}")
            continue
        os.replace(tmp, out)
        _log_path(name).write_text(logs[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: _log_path(n).read_text() for n in SIGNATURES}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed,
    with ``argtypes``/``restype`` declared for its entry points."""
    build_all()
    lib = ctypes.CDLL(str(_library_path(name)))
    for entry, sig in {name: SIGNATURES[name],
                       **EXTRA_ENTRIES.get(name, {})}.items():
        fn = getattr(lib, entry)
        fn.argtypes = list(sig)
        fn.restype = ctypes.c_int
    return lib
