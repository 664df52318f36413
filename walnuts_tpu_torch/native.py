"""The native C++ WALNUTS engine through ctypes: the port's loader for
``native/walnuts_engine.cpp`` (``walnuts_tpu/native/__init__.py``).

The engine is a single-chain, single-core CPU sampler: the honest
single-core baseline for a benchmark's ``vs_baseline`` and a fast CPU
oracle for statistical cross-checks of the card's engines.  It is a
host-CPU oracle in both packages, so this module takes and returns
numpy arrays and has no device argument.

The source is compiled with ``g++ -O3 -std=c++17 -shared -fPIC`` at
first use into ``walnuts_tpu_torch/build/`` (git ignores it), under a
name keyed by a hash of the source and the flags, so a changed source
builds anew; the JAX loader's ``native/libwalnuts_native.so`` is not
touched.  Both loaders compile the same source with the same flags, so
they return the same draws bit for bit.

* :func:`run` — single-chain WALNUTS-R2P / multinomial-NUTS draws;
* :func:`leapfrog_bench` — raw single-core leapfrog throughput.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "walnuts_engine.cpp"
BUILD = Path(__file__).resolve().parent / "build"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

TARGET_IDS = {"std_gauss": 0, "funnel": 1, "corr_gauss": 2}


def library_path() -> Path:
    """Path of the library built from the current source and flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD / f"walnuts_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source if its library is missing; return its path.
    The library is written under a temporary name and renamed, so
    processes that build at once leave one whole file."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native engine builds with a "
                           "C++ toolchain")
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def _load():
    lib = ctypes.CDLL(str(build()))
    vec = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.walnuts_native_run.restype = ctypes.c_longlong
    lib.walnuts_native_run.argtypes = [
        ctypes.c_int, ctypes.c_int, vec,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        vec, vec,
    ]
    lib.walnuts_native_leapfrog_bench.restype = ctypes.c_longlong
    lib.walnuts_native_leapfrog_bench.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_double, ctypes.c_uint64,
    ]
    return lib


def run(target: str, dim: int, q0, n_iter: int, *, h0=0.3, delta=0.3,
        m=10, min_c=0, max_c=10, adaptive=True, seed=0,
        want_diag=False):
    """Run the native sampler; returns ``(draws [n_iter, dim],
    n_grad_evals)``, plus a ``[n_iter, 6]`` per-iteration diagnostics
    array ``{min If, max If, orbit min q[0], orbit max q[0], orbit
    energy error, grad evals}`` when ``want_diag`` is set."""
    lib = _load()
    q0 = np.ascontiguousarray(q0, np.float64)
    out = np.empty((n_iter, dim), np.float64)
    diag = np.empty((n_iter, 6), np.float64)
    n_grad = lib.walnuts_native_run(
        TARGET_IDS[target], dim, q0, n_iter, h0, delta, m, min_c, max_c,
        1 if adaptive else 0, seed, out, diag)
    if want_diag:
        return out, int(n_grad), diag
    return out, int(n_grad)


def leapfrog_bench(target: str, dim: int, n_steps: int, *, h=0.01, seed=0):
    """Run ``n_steps`` raw leapfrog micro steps; returns steps done."""
    lib = _load()
    return int(lib.walnuts_native_leapfrog_bench(
        TARGET_IDS[target], dim, n_steps, h, seed))
