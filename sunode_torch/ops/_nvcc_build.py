"""Build one CUDA source into a ctypes library with ``nvcc``, cached by content.

Every kernel of the port is a ``.cu`` file under ``sunode_torch/csrc/`` with
a plain C interface.  :func:`build_library` compiles it for Hopper
(``sm_90a``) together with the headers generated for it (written next to
the library and found with ``-I``), the compile-time defines and any extra
flags, into ``build/sunode_torch_kernels/<name>_<hash>/``.  The hash covers the source,
the shared headers beside it (``csrc/*.cuh``), the generated headers, the
defines and the flags, so a change to any of them builds anew and an
unchanged build is loaded from disk.  The library is compiled to a temporary name and renamed into place, so processes that
build the same kernel at once never load a half-written file.  A failed
build raises with the compiler's output; there is no fallback.
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
from typing import Mapping, NamedTuple, Sequence

__all__ = ["NvccBuild", "build_library", "NVCC_FLAGS"]

BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "sunode_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class NvccBuild(NamedTuple):
    lib: ctypes.CDLL
    path: Path  # the shared library
    log: str  # nvcc's output ("" when loaded from the cache)
    seconds: float  # build (or load) time


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit on PATH or CUDA_HOME")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build_library(
    name: str,
    source: Path,
    headers: Mapping[str, str] = {},
    defines: Sequence[str] = (),
    extra_flags: Sequence[str] = (),
) -> NvccBuild:
    """Compile ``source`` with ``headers`` ({file name: text}), ``-D``
    ``defines`` and ``extra_flags`` after :data:`NVCC_FLAGS`, or load the
    cached build of the same inputs."""
    flags = [*NVCC_FLAGS, *extra_flags, *(f"-D{d}" for d in defines)]
    parts = [source.read_text(), " ".join(flags)]
    parts += [f"{h.name}\n{h.read_text()}" for h in sorted(source.parent.glob("*.cuh"))]
    parts += [f"{k}\n{v}" for k, v in sorted(headers.items())]
    key = hashlib.sha256("\0".join(parts).encode()).hexdigest()[:16]
    build_dir = BUILD_ROOT / f"{name}_{key}"
    lib_path = build_dir / f"lib{source.stem}.so"
    t0 = time.perf_counter()
    log = ""
    if not lib_path.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        for file_name, text in headers.items():
            (build_dir / file_name).write_text(text)
        tmp = build_dir / f"lib{source.stem}.{os.getpid()}.{threading.get_ident()}.so"
        cmd = [_nvcc(), *flags, "-I", str(build_dir), "-o", str(tmp), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name} from {source.name}:\n{log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    return NvccBuild(lib, lib_path, log, time.perf_counter() - t0)
