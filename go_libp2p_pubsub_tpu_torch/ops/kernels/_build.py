"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes).  All requested sources
build concurrently, one ``nvcc`` process each.  Libraries go to
``build/torch_kernels/`` at the repository root (git-ignored), named by a
hash of the source, the shared headers it may include (``csrc/*.cuh``)
and the flags, so an edited source or header rebuilds.

Nothing here runs at import: the first call of a kernel wrapper builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

# --fmad=false keeps every multiply and add separately rounded, as XLA
# does: the plain versions (and the reference) never contract to FMA.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
#: the sources this process has compiled (one nvcc each)
compiled = 0


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def source_hash(name: str) -> str:
    """The content hash a library is keyed by: its source, the shared
    headers and the flags (16 hex digits)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{source_hash(name)}.so"


def build(names: tuple[str, ...], on_done=None) -> dict[str, str]:
    """Compile the named sources concurrently (those not built yet).

    Returns each compiled source's ptxas report (registers, spills);
    ``on_done(name)`` is called as each source's nvcc exits (a caller
    that times the build reads its clock there).  Raises with nvcc's
    output if any build fails."""
    global compiled
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log_path = out.with_suffix(f".{os.getpid()}.log")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        # (the report goes to a file, so a long one cannot fill a pipe
        # while the others are waited on)
        compiled += 1
        with open(log_path, "w") as log_f:
            procs[name] = (subprocess.Popen(
                cmd, stdout=log_f, stderr=subprocess.STDOUT), tmp, out,
                log_path)
    def wait(name, proc, tmp, out):
        proc.wait()
        if proc.returncode == 0:
            tmp.replace(out)        # loadable as soon as its nvcc is done
        if on_done is not None:
            on_done(name)
    waiters = [threading.Thread(target=wait, args=(name, proc, tmp, out))
               for name, (proc, tmp, out, _) in procs.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    logs, failed = {}, []
    for name, (proc, tmp, out, log_path) in procs.items():
        log = log_path.read_text()
        log_path.unlink()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed:\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
