"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and no PyTorch header, so
`nvcc` builds it in seconds.  It is compiled for `sm_90a` at first use into
`avtubes_torch/_build/<name>-<hash>.so` and loaded with `ctypes`; the hash
covers the source and the flags, so an edited kernel is rebuilt and a stale
library is never loaded.  Whichever kernel is asked for first, every missing
library of `KERNELS` is built in that one batch, all `nvcc` processes
started together, so no later first use compiles on its own; builds are
serialised across processes by a file lock.  A failed
build raises with `nvcc`'s stderr — nothing falls back to another
implementation.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: `-Xptxas -v` makes nvcc report each kernel's registers, shared memory and
#: spills; the report is kept beside the library as `<name>-<hash>.log`.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("stft", "median_select", "correlation", "batchnorm", "temporal_attention")

_loaded: dict[str, ctypes.CDLL] = {}
_loaded_lock = threading.Lock()


def find_nvcc() -> str:
    """Path of `nvcc`: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of avtubes_torch cannot be "
        "built on this machine")


def library_path(name: str) -> Path:
    """Where the library built from the current `csrc/<name>.cu` lives."""
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256()
    h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: tuple[str, ...] = KERNELS) -> dict[str, float]:
    """Compile every named source whose library is missing and, in the
    same batch, every other kernel of `KERNELS` whose library is missing,
    all `nvcc` processes started together.  Returns seconds spent per
    name compiled or asked for (0.0 for a library that was already there).
    Raises RuntimeError on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {n: 0.0 for n in names}
    with open(BUILD_DIR / ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)  # released when the file closes
        todo = [n for n in dict.fromkeys((*names, *KERNELS))
                if not library_path(n).exists()]
        if not todo:
            return seconds
        nvcc = find_nvcc()
        t0 = time.monotonic()
        procs = {}
        for n in todo:
            out = library_path(n)
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True),
                        tmp, out, cmd)
        failures = []
        for n, (proc, tmp, out, cmd) in procs.items():
            stdout, stderr = proc.communicate()
            seconds[n] = time.monotonic() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failures.append(f"{' '.join(cmd)}\nexit {proc.returncode}\n"
                                f"{stdout}{stderr}")
                continue
            out.with_suffix(".log").write_text(stdout + stderr)
            os.replace(tmp, out)  # atomic: a reader never maps half a file
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return seconds


def load_library(name: str) -> ctypes.CDLL:
    """The `ctypes` handle of kernel `name`, built first if need be.  The
    caller declares `argtypes`/`restype` of the functions it uses."""
    with _loaded_lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib


def build_log(name: str) -> str:
    """What `nvcc -Xptxas -v` said when the current library was built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
