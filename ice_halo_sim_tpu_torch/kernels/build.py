"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by nvcc, by hand (one nvcc process per
source, all started together), and linked into ONE shared library with a
plain C interface, loaded with ctypes. The library is built at first use
from the sources in this checkout into ``ice_halo_sim_tpu_torch/_build/``
(listed in .gitignore); its file name carries a hash of the sources and
flags, so an edit rebuilds it. nvcc's ``-Xptxas -v`` report (registers,
shared memory and spills per kernel) is kept in the ``.log`` beside it.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3``, no fast math, and
``--fmad=false``: without contraction the kernels round every multiply and
add as the plain PyTorch twins do, so integer decisions fed by floats
(entry triangle, TIR, pixel floor) agree between the two.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on a non-zero code. Nothing here falls back to the plain
versions. An entry point launches on the CUDA runtime's current device
with the stream it is given, so every wrapper makes its tensors' device
current around the call (``torch.cuda.device``): a tensor on another card
would otherwise be read and written from the wrong device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Launch counts per kernel wrapper: each wrapper adds one where it launches
# its kernel, and nowhere else.
LAUNCHES = {
    "trace_emit": 0,
    "trace_emit_pool": 0,
    "pack_rows": 0,
    "pack_valid_blocks": 0,
    "pack_payload_blocks": 0,
    "scatter_blocks_multi": 0,
    "scatter_blocks": 0,
    "compact_rows": 0,
    "fused_scan": 0,
    "fused_scan_extract": 0,
    "sandwich_lane": 0,
    "sandwich_sublane": 0,
    "sandwich_iota": 0,
    "extract_blocks": 0,
    "radix_sort": 0,
    "radix_sort_pass": 0,  # the digit passes of those launches
    "trace_layer": 0,
}

_lib = None
build_seconds = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return cand


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libiht_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if this source state has not been built."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    cu = [s for s in _sources() if s.endswith(".cu")]
    tmp = out + f".tmp{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cu]
    t0 = time.time()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", obj, src],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, obj in zip(cu, objs)
    ]
    log, failed = "", None
    for src, proc in zip(cu, procs):
        so, se = proc.communicate()
        log += f"== {os.path.basename(src)}\n{so}{se}"
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, se)
    try:
        if failed is None:
            link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                                  capture_output=True, text=True)
            log += f"== link\n{link.stdout}{link.stderr}"
            if link.returncode != 0:
                failed = (link.returncode, link.stderr)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        with open(out + ".log", "w") as f:
            f.write(log)
    if failed is not None:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{failed[1][-8000:]}")
    os.replace(tmp, out)
    build_seconds = time.time() - t0
    return out


def ptxas_report(kernel: str) -> list:
    """The ``-Xptxas -v`` lines (registers, spills, shared memory) of every
    compiled kernel whose mangled name contains `kernel`, from the build
    log of the current library."""
    with open(library_path() + ".log") as f:
        lines = f.read().splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            out.append(" | ".join(x.strip() for x in lines[i:i + 4]))
    return out


_VP = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_LL = ctypes.c_longlong

_SIGNATURES = {
    "iht_trace_emit": [_VP] * 9,
    "iht_trace_emit_pool": [_VP] * 11,
    "iht_pack_blocks": [_VP, _VP, _VP, _VP, _I, _U, _I, _I,
                        _VP, _VP, _VP, _VP, _VP, _VP],
    "iht_scatter_blocks": [_VP, _I, _VP, _VP, _I, _I, _LL, _VP, _I, _LL, _LL, _I, _U, _VP],
    "iht_compact_rows": [_VP, _VP, _I, _LL, _LL, _VP, _VP, _VP, _I, _VP],
    "iht_fused_scan": [_VP, _VP, _VP, _I, _I, _LL, _VP, _VP, _VP, _VP,
                       _VP, _VP, _VP],
    "iht_fused_scan_extract": [_VP, _VP, _VP, _I, _I, _LL, _VP, _I, _VP, _VP, _VP],
    "iht_sandwich_lane": [_VP, _VP, _VP, _VP, _VP, _LL, _I, _I, _I, _I, _I, _LL, _I,
                          _VP, _VP, _VP, _VP, _VP],
    "iht_sandwich_sublane": [_VP, _VP, _VP, _VP, _VP, _LL, _I, _I, _I, _I, _I, _I,
                             _VP, _VP, _VP, _VP, _VP, _LL, _VP],
    "iht_sandwich_iota": [_VP, _VP, _VP, _VP, _LL, _I, _I, _I, _I, _I, _VP, _VP, _VP, _LL, _VP],
    "iht_radix_sort_pairs": [_VP, _VP, _LL, _I, _I, _VP, _VP, _VP, _VP, _VP, _LL, _VP],
    "iht_trace_layer": [_VP, _VP],
}


def lib():
    """The loaded kernel library (built at first use, in the set-up span
    ``iht.setup.library``: utils/profiling.py)."""
    global _lib
    if _lib is None:
        from ice_halo_sim_tpu_torch.utils import profiling

        with profiling.setup_span("iht.setup.library"):
            _lib = _load()
    return _lib


def _load():
    """Build the library if needed and load it, its signatures declared."""
    handle = ctypes.CDLL(build())
    for name, args in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    handle.iht_sandwich_smem.argtypes = [_I, _I]
    handle.iht_sandwich_smem.restype = ctypes.c_longlong
    handle.iht_error_string.argtypes = [_I]
    handle.iht_error_string.restype = ctypes.c_char_p
    return handle


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib().iht_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError {code} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def ptr_array(tensors):
    """A host array of the tensors' device pointers, for an entry point that
    takes a variable number of columns."""
    return (_VP * len(tensors))(*[t.data_ptr() for t in tensors])
