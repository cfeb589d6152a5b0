"""Build and load the port's CUDA kernels (``fastspeech2_tpu_torch/csrc``).

Each ``.cu`` source is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library
with a plain C interface, which is loaded with ``ctypes``.  No PyTorch
header is involved, so a build takes seconds.  The library lands in
``fastspeech2_tpu_torch/_build/`` (ignored by git) under a name keyed by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Nothing is built at import: the first
kernel launch (or an explicit :func:`load_library`) builds.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("attention.cu", "attention_bwd.cu", "conv_ffn.cu", "resblock.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (all return int, a cudaError_t)
_SIGNATURES = {
    # q, k, v, key_pad, out, row_max, row_sum, B, H, L, D, scale, stream
    "fs2_mha_fwd_f32": [_P] * 7 + [_I] * 4 + [ctypes.c_float, _P],
    # q, k, v, key_pad, out, row_max, row_sum, g, dq, dk, dv, d_scratch,
    # B, H, L, D, scale, stream
    "fs2_mha_bwd_f32": [_P] * 12 + [_I] * 4 + [ctypes.c_float, _P],
    # x, w1, b1, w2, b2, gamma, beta, h, out, B, L, D, H, k1, k2, stream
    "fs2_conv_ffn_fwd_f32": [_P] * 9 + [_I] * 6 + [_P],
    # x, t, out, w1, b1, w2, b2, B, C, L, k, d, stream
    "fs2_resblock_unit_f32": [_P] * 7 + [_I] * 5 + [_P],
}

_library = None
build_info = {}   # filled by the build: path, seconds, ptxas report


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source at first use and need the CUDA toolkit")


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _build(target):
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC_DIR, name),
                   "-o", obj]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        reports = []
        for name, _, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{out}")
            reports.append(out)
        partial = os.path.join(tmp, os.path.basename(target))
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *(obj for _, obj, _ in procs), "-o", partial],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(partial, target)   # atomic: concurrent builds agree
    build_info.update(seconds=time.perf_counter() - t0,
                      ptxas="".join(reports), built=True)


def load_library():
    """Build (if needed) and load the kernels' shared library."""
    global _library
    if _library is not None:
        return _library
    target = os.path.join(BUILD_DIR, f"libfs2_kernels_{_digest()}.so")
    build_info.update(path=target, built=False, seconds=0.0)
    if not os.path.exists(target):
        _build(target)
    lib = ctypes.CDLL(target)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _library = lib
    return lib


def check(err, name):
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")
