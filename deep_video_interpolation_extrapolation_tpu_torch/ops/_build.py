"""Build and load the CUDA kernels of ``csrc/``.

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process,
all started together, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers: the
build takes seconds, not minutes).  The output goes to ``_build/`` in the
package and is keyed by a hash of the sources and flags, so an unchanged tree
does not rebuild.  A missing ``nvcc`` or a failed build raises with the
compiler's output; nothing falls back.

Every exported function takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launches (a backward
queues two and stops at the first error).
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

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
                     "-v"]

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# C signature of every exported function: (name, argtypes)
SIGNATURES = {
    # x, w, bias, res, out, B, H, W, Cin, Cout, relu, stream
    "dvie_conv3x3": [P, P, P, P, P, I, I, I, I, I, I, P],
    # h1, x, wu, y, h1n, B, H, W, res, next, stream
    "dvie_bottleneck_tail": [P] * 5 + [I] * 5 + [P],
    # p0, p1, p2, w1u, b1, w2u, yt, B, H, W, H1, W1, H2, W2, C0, C1, C2,
    # N1, N2, stream
    "dvie_ups_head_taps": [P, P, P, P, P, P, P] + [I] * 12 + [P],
    # the same at the taps width 216
    "dvie_ups_head_taps_n216": [P, P, P, P, P, P, P] + [I] * 12 + [P],
    # p0, p1, p2, w1u, b1, h, B, H, W, H1, W1, H2, W2, C0, C1, C2, N1, stream
    "dvie_ups_head_1x1": [P] * 6 + [I] * 11 + [P],
    # x16, w1u, b1, w2u, b2, y, s1 (or NULL), B, H, W, stream
    "dvie_stem_fwd": [P] * 7 + [I] * 3 + [P],
    # dy, y, s1, x16, w2f, wxf, dpre2, dpre1, dx, dk2p, dk1p, dbp, B, H, W,
    # cx, s0, s1, stream
    "dvie_stem_bwd": [P] * 12 + [I] * 6 + [P],
    # the same two at 48 input channels
    "dvie_stem48_fwd": [P] * 7 + [I] * 3 + [P],
    "dvie_stem48_bwd": [P] * 12 + [I] * 6 + [P],
    # and at 64
    "dvie_stem64_fwd": [P] * 7 + [I] * 3 + [P],
    "dvie_stem64_bwd": [P] * 12 + [I] * 6 + [P],
    # x, wu, y, B, H, W, Ci, stream
    "dvie_bottleneck_fwd": [P] * 3 + [I] * 4 + [P],
    # x, dy, wf, wb, h1, h2, dpre_y, dpre2, dpre1, dx, B, H, W, Ci, stream
    "dvie_bottleneck_bwd": [P] * 10 + [I] * 4 + [P],
    # x, h1, h2, dpre2, dpre1, dpre_y, out, B, H, W, Ci, s0, s1, stream
    "dvie_bottleneck_wgrad": [P] * 7 + [I] * 6 + [P],
    # x, w1u, w2u, y, h, B, H, W, C, stream
    "dvie_bb_chain_fwd": [P] * 5 + [I] * 4 + [P],
    # dy, y, h, w1u, w2u, dx, dpre_h, dpre_y, B, H, W, C, stream
    "dvie_bb_chain_bwd": [P] * 8 + [I] * 4 + [P],
    # host array of n (a, d, out) pointers, n, C, B, H, W, splits, stream
    "dvie_bb_chain_wgrad": [P] + [I] * 6 + [P],
    # p0, p1, p2, p3, w1u, b1, w2u, yt, B, H, W, H1, W1, H2, W2, H3, W3, C0,
    # C1, C2, C3, N1, N2, stream
    "dvie_ups_head_taps4": [P] * 8 + [I] * 15 + [P],
    # the same at the taps width 216
    "dvie_ups_head_taps4_n216": [P] * 8 + [I] * 15 + [P],
    # p0, p1, p2, p3, w1u, b1, h, B, H, W, H1, W1, H2, W2, H3, W3, C0, C1,
    # C2, C3, N1, NH, stream
    "dvie_ups_head_1x1_4": [P] * 7 + [I] * 15 + [P],
    # q, k1, k2, v1, v2, out, flow, B, H, W, win_h, win_w, kv_same, stream
    "dvie_window_attn": [P] * 7 + [I] * 6 + [P],
    # yt, b2, out, B, H, W, stream (co = 23)
    "dvie_shifted_add_bias": [P] * 3 + [I] * 3 + [P],
    # the same at co = 24
    "dvie_shifted_add_bias_co24": [P] * 3 + [I] * 3 + [P],
    # x, grid, out, B, H, W, C, max_disp (-1: unbounded), x is bf16, stream
    "dvie_grid_sample": [P] * 3 + [I] * 6 + [P],
    # x, flow, mask (or NULL), bx, by, out, B, T, H, W, C, max_disp, x is
    # bf16, flow is bf16, x's frame stride, flow's strides (b, t: L; h, w,
    # c: I), mask's (b, t: L; h, w: I), stream
    "dvie_warp_steps": [P] * 6 + [I] * 8 + [L] * 3 + [I] * 3 + [L] * 2
    + [I] * 2 + [P],
    # x, flow, mask (or NULL), bx, by, dout, dflow, dmask (or NULL), B, T, H,
    # W, C, x is bf16, flow is bf16, x's frame stride, flow's strides (b, t:
    # L; h, w, c: I), mask's (b, t: L; h, w: I), stream
    "dvie_warp_steps_bwd": [P] * 8 + [I] * 7 + [L] * 3 + [I] * 3 + [L] * 2
    + [I] * 2 + [P],
    # feat, w1u, b1, w2u, yt, B, H, W, C, N1, N2, stream
    "dvie_dual_head_taps": [P] * 5 + [I] * 6 + [P],
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
    """Compile the kernels unless a library of the same sources exists:
    one ``nvcc -c`` per source, all at once, then one link.  The compilers'
    output (``-Xptxas -v``: registers, shared memory, spills per kernel) is
    kept beside the library as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD / f"{tag}.{src.stem}.o" for src in sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources(), objs)]
    logs = [(src.name, p.communicate()[0], p.returncode)
            for src, p in zip(sources(), procs)]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not any(rc for _, _, rc in logs):
        proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        logs.append(("link", proc.stdout + proc.stderr, proc.returncode))
    failed = [f"{name} ({rc})" for name, _, rc in logs if rc]
    text = "".join(f"== {name}\n{log}" for name, log, _ in logs)
    out.with_suffix(".log").write_text(text)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{text}")
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
