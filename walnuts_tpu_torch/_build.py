"""Build the CUDA sources under ``csrc/`` at first use.

``nvcc`` compiles every ``walnuts_tpu_torch/csrc/*.cu`` into one shared
library with a plain C interface under ``walnuts_tpu_torch/build/``,
named by a hash of the sources and flags, so a changed source builds
anew and an unchanged one loads at once.  Nothing but the repository's
sources goes in.  A failed build raises with nvcc's output.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile", "0"]


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA round kernel builds on a "
                       "machine with the CUDA toolkit")


def library_path():
    """Path of the library built from the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sorted(CSRC.glob("*.cu*")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD / f"walnuts_kernels_{h.hexdigest()[:16]}.so"


def build():
    """Compile the sources if their library is missing; return its path
    and the compiler's output (empty when it was already built)."""
    out = library_path()
    if out.exists():
        return out, ""
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    log = proc.stdout + proc.stderr
    out.with_suffix(".log").write_text(log)
    return out, log


@functools.lru_cache(maxsize=1)
def load():
    """The built library, loaded once per process."""
    path, _ = build()
    return ctypes.CDLL(str(path))
