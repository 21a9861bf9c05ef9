"""Build and load the port's CUDA kernels.

Every ``kernels/<package>/csrc/<name>.cu`` is compiled at first use by
``nvcc`` into its own shared library with a plain C interface, which
``ctypes`` loads (no PyTorch headers, so a build takes seconds, not
minutes). Libraries go to ``build/repro_torch/`` at the repository root,
named by a hash of the source, the headers beside it and in
``kernels/common/``, and the flags, so a changed source is rebuilt and an
unchanged one is not. All stale sources are compiled at once, one ``nvcc``
process each.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; the Python wrappers raise if that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

KERNELS_DIR = Path(__file__).resolve().parent
COMMON_DIR = KERNELS_DIR / "common"   # headers every kernel may include
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel name -> its CUDA source, for every kernel of the port."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def nvcc() -> str:
    """Path of the CUDA compiler; raises if the toolkit is missing."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's kernels are built "
        "from their CUDA sources at first use")


def target(src: Path) -> Path:
    """The library a source builds into, named by the content of the source,
    of the headers beside it (``csrc/*.cuh``) and of the shared ones
    (``kernels/common/*.cuh``), and by the flags."""
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for hdr in (sorted(src.parent.glob("*.cuh"))
                + sorted(COMMON_DIR.glob("*.cuh"))):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Compile every kernel whose library is missing or stale, all in
    parallel; returns kernel name -> library path. ``verbose`` adds
    ``-Xptxas -v`` and prints the compiler's report (registers, shared
    memory, spills) for each source it builds."""
    srcs = sources()
    targets = {name: target(src) for name, src in srcs.items()}
    stale = {name: src for name, src in srcs.items()
             if not targets[name].exists()}
    if not stale:
        return targets
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas", "-v") if verbose else ()
    procs = {}
    for name, src in stale.items():
        tmp = targets[name].with_name(f"{targets[name].name}.{os.getpid()}")
        cmd = [exe, *NVCC_FLAGS, *extra, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    errors = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"{stale[name]} (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, targets[name])
        if verbose:
            print(f"[build] {stale[name].name}\n{out}", flush=True)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build_all()[name]))
    return lib


def launcher(name: str, argtypes):
    """Kernel ``name``'s C entry point ``<name>_launch`` with its ctypes
    signature set (``argtypes`` in order; it returns an int error code)."""
    fn = getattr(load(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by an entry point."""
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch "
                           "(cudaGetLastError)")
