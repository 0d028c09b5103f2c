"""Build and load the CUDA kernels of ``csrc/``.

At first use every ``csrc/*.cu`` is compiled by ``nvcc`` into one shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers:
the build takes seconds, not minutes).  The output goes to ``_build/`` in the
package and is keyed by a hash of the sources and flags, so an unchanged tree
does not rebuild.  A missing ``nvcc`` or a failed build raises with the
compiler's output; nothing falls back.

Every exported function takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launches (a backward
queues three and stops at the first error).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I = ctypes.c_void_p, ctypes.c_int

# C signature of every exported function: (name, argtypes)
SIGNATURES = {
    # x, w, bias, res, out, B, H, W, Cin, Cout, relu, stream
    "dvie_conv3x3": [P, P, P, P, P, I, I, I, I, I, I, P],
    # h1, x, w2, w3, wres, w1n, y, h1n, B, H, W, Cx, stream
    "dvie_bottleneck_tail": [P, P, P, P, P, P, P, P, I, I, I, I, P],
    # p0, p1, p2, w1, b1, w2t, yt, B, H, W, H1, W1, H2, W2, C0, C1, C2,
    # N1, N2, stream
    "dvie_ups_head_taps": [P, P, P, P, P, P, P] + [I] * 12 + [P],
    # p0, p1, p2, w1, b1, h, B, H, W, H1, W1, H2, W2, C0, C1, C2, N1, stream
    "dvie_ups_head_1x1": [P] * 6 + [I] * 11 + [P],
    # x16, w1, b1, w2, b2, y, B, H, W, stream
    "dvie_stem_fwd": [P] * 6 + [I] * 3 + [P],
    # x16, dy, w1, b1, w2, b2, w1f, w2f, dpre2, s1, dpre1, dx16, pk1, pb1,
    # pk2, pb2, B, H, W, splits, stream
    "dvie_stem_bwd": [P] * 16 + [I] * 4 + [P],
    # x, w1, w2, w3, wres, y, B, H, W, Ci, stream
    "dvie_bottleneck_fwd": [P] * 6 + [I] * 4 + [P],
    # x, dy, w1, w2, w3, wres, w1t, w2f, w3t, wrest, h1, h2, dpre_y, dpre2,
    # dpre1, dx, pk1, pk2, pk3, pkres, B, H, W, Ci, splits, stream
    "dvie_bottleneck_bwd": [P] * 20 + [I] * 5 + [P],
}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and PATH): "
            "the Hopper kernels cannot be built")
    return found


def sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"libdvie_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists.
    The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills per kernel) is kept beside the library as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call; one handle per
    process)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (NULL) for an absent operand."""
    return None if t is None else t.data_ptr()


def stream(t) -> int:
    """The current CUDA stream of a tensor's device, as a pointer."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
