"""Build the CUDA sources in ``csrc/`` into one shared library at first use.

Each ``.cu`` file is compiled by its own ``nvcc`` process (all started
together), then the objects are linked into one ``.so`` with a plain C
interface, loaded with ``ctypes``.  The library's name carries a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is loaded from ``_build/`` as it is.  Nothing is built on import.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib: ctypes.CDLL | None = None
_fns: dict = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def library_path(csrc: Path = CSRC) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(csrc.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"librepro_kernels_{h.hexdigest()[:16]}.so"


def build(csrc: Path = CSRC) -> Path:
    """Compile and link the library of the sources in ``csrc`` (this
    tree's by default) unless it is already built; returns its path.  The
    compiler's output (with ``ptxas -v`` register and spill counts) is
    kept beside it as ``<name>.log``."""
    so = library_path(csrc)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sorted(csrc.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [exe, *NVCC_FLAGS, "-c", str(src), "-o", obj]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_so = os.path.join(tmp, so.name)
        link = subprocess.run(
            [exe, "-shared", "-o", tmp_so] + [obj for _, obj, _ in jobs]
            + ["-lcudart"], capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"link failed:\n{link.stdout}{link.stderr}")
        so.with_suffix(".log").write_text("\n".join(log))
        os.replace(tmp_so, so)
    return so


def function(name: str, argtypes: list):
    """The library's C entry ``name`` with its signature declared; every
    entry returns the ``cudaError_t`` of its launch (0 = success)."""
    global _lib
    fn = _fns.get(name)
    if fn is None:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        fn = getattr(_lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


@contextlib.contextmanager
def using(so: Path):
    """Inside the block every entry point calls the library at ``so``
    (another tree's build, from :func:`build`), then this tree's again."""
    global _lib, _fns
    saved = _lib, _fns
    _lib, _fns = ctypes.CDLL(str(so)), {}
    try:
        yield
    finally:
        _lib, _fns = saved


def check(err: int, name: str) -> None:
    if err:
        what = function("repro_cuda_error_string", [ctypes.c_int])
        what.restype = ctypes.c_char_p
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"({what(err).decode()})")
