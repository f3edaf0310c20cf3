"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``: pointers go in as
``c_void_p`` from ``Tensor.data_ptr()``, the stream as
``torch.cuda.current_stream().cuda_stream``.  No PyTorch header is compiled,
so a build takes seconds (``torch.utils.cpp_extension.load`` takes minutes
for one file).

Libraries build at first use into ``ray_tpu_torch/_build/``, named by a hash
of their source, the headers in ``csrc/`` and the flags, so a fresh checkout
builds everything on its first call and a changed source or header
rebuilds.  ``build()`` starts one ``nvcc`` per
source, all at once.  Nothing here runs at import: the CPU tests import every
module on machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("flash_fwd", "flash_bwd", "paged_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}
#: name -> {"seconds": wall time of the parallel build, "ptxas": nvcc's
#: output lines, with ``-Xptxas -v``'s registers, shared memory and spills
#: per kernel} for every library this process compiled.
build_log: Dict[str, dict] = {}
#: ``listener(kind, what, seconds)`` told of each library built or loaded
#: here ("build", name) and of each first launch of a new launch key
#: ("launch", kernel), or None: ``profiler.recompile`` installs it.  Each
#: hook sits on a miss path and is this one check when nothing listens.
compile_listener = None


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location.  Raises where none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build ray_tpu_torch's kernels")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, every header in
    ``csrc/`` (any source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns the ``build_log``
    entries of what it compiled; raises with nvcc's output on failure."""
    todo = [(n, library_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not p.exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    try:
        for name, path in todo:
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            procs.append((name, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        outputs = [(name, path, tmp, p.communicate()[0], p.returncode)
                   for name, path, tmp, p in procs]
    finally:
        for *_rest, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(n, out) for n, _p, _t, out, rc in outputs if rc != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n}.cu\n{out}" for n, out in failed))
    seconds = time.perf_counter() - t0
    done = {}
    for name, path, tmp, out, _rc in outputs:
        os.replace(tmp, path)
        done[name] = {"seconds": seconds,
                      "ptxas": [ln.strip() for ln in out.splitlines()
                                if ln.strip()]}
    build_log.update(done)
    return done


def function(name: str, symbol: str, argtypes: Sequence,
             restype=ctypes.c_int):
    """The C entry point ``symbol`` of library ``name`` with its ctypes
    signature set, building and loading the library on first use."""
    key = (name, symbol)
    with _lock:
        fn = _fns.get(key)
        if fn is None:
            lib = _libs.get(name)
            if lib is None:
                t0 = time.perf_counter()
                build([name])
                lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
                if compile_listener is not None:
                    compile_listener("build", name, time.perf_counter() - t0)
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = restype
            _fns[key] = fn
    return fn


def count_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel: ``wrapper.launches`` and
    ``wrapper.launches_by_thread[<this thread's name>]``, both under one
    lock (``x += 1`` is a read, an add and a write, and drops counts when
    threads interleave; serving launches from several threads at once)."""
    name = threading.current_thread().name
    with _count_lock:
        wrapper.launches += 1
        by = wrapper.launches_by_thread
        by[name] = by.get(name, 0) + 1


def check(name: str, code: int, what: str) -> None:
    """Raise if a C entry point of library ``name`` returned a CUDA error
    (a launch refused for its shape or shared memory never runs, and a
    later synchronize would not report it)."""
    if code == 0:
        return
    err = function(name, "rt_error_string", [ctypes.c_int],
                   restype=ctypes.c_char_p)
    msg = err(code).decode()
    raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def ptxas_lines() -> List[str]:
    return [ln for entry in build_log.values() for ln in entry["ptxas"]]
