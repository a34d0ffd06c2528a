"""Compile ``csrc/*.cu`` with nvcc on first use and load it with ctypes.

Each source is its own shared library with a plain C interface (no PyTorch
headers, so a build takes seconds). The library lands in ``build/kernels/``
at the repository root, named by a hash of the source and the compiler
flags, so an edited source rebuilds and an unchanged one is reused. Only
the sources in this package are compiled.

Usage:
    lib = load("fused_preprocess")   # builds csrc/fused_preprocess.cu
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# sm_90a: Hopper with its architecture-specific features. -fmad=false keeps
# every product and sum separately rounded, matching the plain PyTorch
# versions operation for operation (see each source's note).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> (seconds the build took, or 0.0 when reused; ptxas report)
build_info: Dict[str, tuple] = {}


def nvcc_path() -> str:
  cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
  candidate = os.path.join(cuda_home, "bin", "nvcc")
  if os.path.exists(candidate):
    return candidate
  found = shutil.which("nvcc")
  if found is None:
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels are built from source on first use")
  return found


def _library_path(name: str) -> Path:
  source = (CSRC / f"{name}.cu").read_bytes()
  digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()
                          ).hexdigest()[:16]
  return BUILD_DIR / f"lib{name}-{digest}.so"


def load(name: str) -> ctypes.CDLL:
  """The loaded library of ``csrc/<name>.cu``, building it if needed."""
  with _lock:
    lib = _loaded.get(name)
    if lib is not None:
      return lib
    path = _library_path(name)
    if path.exists():
      build_info[name] = (0.0, "")
    else:
      build_info[name] = _compile(CSRC / f"{name}.cu", path)
    lib = ctypes.CDLL(str(path))
    _loaded[name] = lib
    return lib


def _compile(source: Path, out: Path) -> tuple:
  out.parent.mkdir(parents=True, exist_ok=True)
  # Build under a temporary name and rename, so concurrent processes never
  # load a half-written library.
  fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
  os.close(fd)
  t0 = time.perf_counter()
  try:
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
      raise RuntimeError(f"nvcc failed on {source.name}:\n{proc.stderr}")
    os.replace(tmp, out)
  finally:
    if os.path.exists(tmp):
      os.unlink(tmp)
  return time.perf_counter() - t0, proc.stderr
