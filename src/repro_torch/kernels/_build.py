"""Build and load the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds. Libraries go to ``build/kernels/`` at the
repository root (git-ignored), named by a digest of the source and the flags,
so an edited source is rebuilt and an unchanged one is reused. A kernel whose
wrapper module holds ``NVCC_DEFINES`` is compiled with those values as ``-D``
macros, so the wrapper and the source read one set of constants. Nothing is
compiled at import: the first launch of a kernel builds it, or ``build_all``
builds every kernel at once with one ``nvcc`` process per source.

``nvcc`` is found on ``PATH``, else under ``$CUDA_HOME/bin`` (default
``/usr/local/cuda``). A failed build raises ``RuntimeError`` with the
compiler's output; ptxas' register and shared-memory report for each build is
kept beside the library as ``<name>-<digest>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("systolic_gemm", "approx_gemm", "delta_gemm", "paged_attention",
           "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built")
    return path


def defines(name: str) -> Tuple[str, ...]:
    """The ``-D`` flags of kernel ``name``: its wrapper module's
    ``NVCC_DEFINES``, if it has them."""
    mod = importlib.import_module(f"{__package__}.{name}")
    return tuple(f"-D{k}={v}"
                 for k, v in sorted(getattr(mod, "NVCC_DEFINES", {}).items()))


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join(NVCC_FLAGS + defines(name))
    digest = hashlib.blake2b(src + flags.encode(), digest_size=8).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, pathlib.Path]:
    """Compile every named kernel that has no up-to-date library, in parallel.

    Returns name -> library path. Raises ``RuntimeError`` naming each source
    that failed, with the compiler's output.
    """
    names = list(names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *defines(n), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            msg = getattr(lib, f"{name}_error_string")
            msg.argtypes, msg.restype = [ctypes.c_int], ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check_gemm_operands(name: str, a, b, *extra) -> None:
    """Raise unless ``a`` (M,K) and ``b`` (K,N) are contiguous int8 tensors
    on one CUDA device, with every tensor of ``extra`` on that device: what
    the GEMM kernels take."""
    import torch
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name} wants (M,K) x (K,N), got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    devices = {t.device for t in (a, b, *extra)}
    if a.device.type != "cuda" or len(devices) != 1:
        raise ValueError(f"{name}: tensors on {sorted(map(str, devices))}; "
                         "all must be on one CUDA device or all on the CPU")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"{name} wants int8 operands, got {a.dtype} and "
                        f"{b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name} wants contiguous operands")


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (the launchers size grids by it)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(name: str, err: int) -> None:
    """Raise if kernel ``name``'s C launcher returned a nonzero cudaError_t."""
    if err != 0:
        text = getattr(_LIBS[name], f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {text} (cudaError {err})")
