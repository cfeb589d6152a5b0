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
SOURCES = ("attention.cu", "attention_bwd.cu", "attention_bf16.cu",
           "attention_bwd_bf16.cu", "conv_ffn.cu", "conv_ffn_f32.cu",
           "resblock.cu")
# headers the sources include (hashed with them)
HEADERS = ("attention_bf16.cuh", "attention_common.cuh", "attention_f32.cuh",
           "conv_tiles.cuh", "hopper.cuh", "tf32_mma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types; each returns an int (a
# cudaError_t or a count) unless _RESTYPES names another type
_SIGNATURES = {
    # q, k, v, key_pad, out, row_max, row_sum, scratch, B, H, L, D, scale,
    # stream
    "fs2_mha_fwd_f32": [_P] * 8 + [_I] * 4 + [ctypes.c_float, _P],
    "fs2_mha_fwd_bf16": [_P] * 8 + [_I] * 4 + [ctypes.c_float, _P],
    # B, H, L, bf16, stats, grid (int[3], written) -> scratch floats (long
    # long)
    "fs2_mha_fwd_plan": [_I] * 5 + [_P],
    # q, k, s, B, H, L, route, stream: raw scores through K1's routine
    # (route 1), K3b's (2) or K3a's (3) (the score contract's check)
    "fs2_mha_scores_f32": [_P] * 3 + [_I] * 4 + [_P],
    "fs2_mha_fwd_blocks_per_sm": [],
    "fs2_mha_fwd_f32_smem_bytes": [],
    "fs2_mha_bwd_blocks_per_sm": [],
    # -> dynamic shared memory bytes of a block of the float32 K3
    "fs2_mha_bwd_f32_smem_bytes": [],
    "fs2_mha_fwd_bf16_blocks_per_sm": [],
    "fs2_mha_bwd_bf16_blocks_per_sm": [],
    "fs2_mha_bwd_bf16_dq_blocks_per_sm": [],
    # q, k, v, key_pad, out, row_max, row_sum, g, dq, dk, dv, scratch,
    # B, H, L, D, scale, stream
    "fs2_mha_bwd_f32": [_P] * 12 + [_I] * 4 + [ctypes.c_float, _P],
    # the same without out (the bfloat16 instance forms D from S and dP)
    "fs2_mha_bwd_bf16": [_P] * 11 + [_I] * 4 + [ctypes.c_float, _P],
    # B, H, L, bf16 -> scratch floats (long long)
    "fs2_mha_bwd_scratch_floats": [_I] * 4,
    # x, w1, b1, w2, b2, gamma, beta, scratch, out, B, L, D, H, k1, k2,
    # splits, groups, stream
    "fs2_conv_ffn_fwd_f32": [_P] * 9 + [_I] * 8 + [_P],
    # the same at bfloat16
    "fs2_conv_ffn_fwd_bf16": [_P] * 9 + [_I] * 8 + [_P],
    # B, L, H, k1, k2, cfg (int[2], written) -> scratch floats (long long)
    "fs2_conv_ffn_f32_plan": [_I] * 5 + [_P],
    # the same at bfloat16
    "fs2_conv_ffn_plan": [_I] * 5 + [_P],
    # -> dynamic shared memory bytes of a block of the bfloat16 K2
    "fs2_conv_ffn_bf16_smem_bytes": [],
    # conv2 (0: the first conv) -> dynamic shared memory bytes of a block
    "fs2_conv_ffn_f32_smem_bytes": [_I],
    # in, w, bias, res, out, B, C, L, k, d, first, nb, stream
    "fs2_resblock_conv_f32": [_P] * 5 + [_I] * 7 + [_P],
    # B, C, L -> output channels per block
    "fs2_resblock_n_block": [_I] * 3,
    # nb -> dynamic shared memory bytes of a block
    "fs2_resblock_smem_bytes": [_I],
}

_RESTYPES = {"fs2_mha_fwd_plan": ctypes.c_longlong,
             "fs2_mha_bwd_scratch_floats": ctypes.c_longlong,
             "fs2_conv_ffn_plan": ctypes.c_longlong,
             "fs2_conv_ffn_f32_plan": ctypes.c_longlong}

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
    for name in SOURCES + HEADERS:
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
        report = "".join(reports)
        with open(partial + ".ptxas.txt", "w") as f:
            f.write(report)
        os.replace(partial + ".ptxas.txt", target + ".ptxas.txt")
        os.replace(partial, target)   # atomic: concurrent builds agree
    build_info.update(seconds=time.perf_counter() - t0, ptxas=report,
                      built=True)


def load_library():
    """Build (if needed) and load the kernels' shared library."""
    global _library
    if _library is not None:
        return _library
    target = os.path.join(BUILD_DIR, f"libfs2_kernels_{_digest()}.so")
    build_info.update(path=target, built=False, seconds=0.0)
    if not os.path.exists(target):
        _build(target)
    elif os.path.exists(target + ".ptxas.txt"):
        with open(target + ".ptxas.txt") as f:
            build_info["ptxas"] = f.read()   # the report of the build
    lib = ctypes.CDLL(target)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    _library = lib
    return lib


def check(err, name):
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")
