"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/lib<name>-<hash>.so`` at the root of the checkout, for
``sm_90a`` (Hopper), linked against the libraries that ``LIBS`` names for
it (``decode_crop``: nvJPEG, found through the toolkit's ``lib64``).  The
hash covers the source, the shared headers (``csrc/*.cuh``) and the flags
and libraries, so an edited source or header never loads a stale
library.  Builds happen at first use,
never at import; :func:`build_all` starts one nvcc per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Libraries a source links against, beside the CUDA runtime.
LIBS = {"decode_crop": ["-lnvjpeg"]}

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _link_flags(name: str, nvcc: str) -> List[str]:
    """``LIBS[name]``, with the toolkit's ``lib64`` to find them in at
    build and at load time."""
    if name not in LIBS:
        return []
    lib64 = str(Path(nvcc).resolve().parents[1] / "lib64")
    return ["-L", lib64, "-Xlinker", f"-rpath={lib64}", *LIBS[name]]


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + LIBS.get(name, [])).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[Path, Path, subprocess.Popen]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    nvcc = _nvcc()
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu"),
           *_link_flags(name, nvcc)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return _target(name), Path(tmp), proc


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no current library, all at once.

    Returns nvcc's output (ptxas register and shared-memory report) by
    name; raises if any build fails.
    """
    jobs = {n: _start(n) for n in names if not _target(n).exists()}
    logs, failed = {}, []
    for name, (target, tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, target)  # atomic: concurrent builds agree
        else:
            tmp.unlink(missing_ok=True)
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    if name not in _LOADED:
        build_all([name])
        _LOADED[name] = ctypes.CDLL(str(_target(name)))
    return _LOADED[name]
