"""Time and check the attention kernels K1 and K3 on a CUDA card.

Three parts, each optional:

- ``--timings``: K1 and K3 at every shape of the port's paths (K1 at
  [1, 2, 32|1000, 128] for the README sentence, [8, 2, 128|1000, 128] for
  batch mode, [16, 2, 128|1000, 128] for serving, K1 and K3 at
  [10, 2, 128|768|1000, 128] for training), with the plain versions and
  SDPA (forward, and its backward for K3) on the same inputs; CUDA events
  over 20 calls after 3 warm-up calls, as ``chip_smoke.py`` times them,
  and for K1 and SDPA's forward also the device time (the kernels' own
  durations in a torch.profiler trace, no host time).
  ``--root DIR`` times the kernels of the port in another checkout (for
  example an unpacked parent commit): its ``fastspeech2_tpu_torch`` is
  imported instead of this one, and built there.  ``--dtype bfloat16``
  times the kernels' bfloat16 instances (inputs, and SDPA's, in
  bfloat16).
- ``--split-sweep 1,2,4,8,16``: K1 built once for each fixed count of key
  chunks (``-DFS2_MHA_FWD_CHUNKS=c``, into ``_build/sweep/``), timed at
  K1's path shapes and held against the plain version, beside the chunk
  count the built-in rule picks; at ``--dtype bfloat16`` the bfloat16
  instance (its own tiles and plan).
- ``--errors``: at [10, 2, 1000, 128], the error of K1's output and of K3's
  gradients against a float64 evaluation of the same formulas, beside
  that of the plain float32 version and of the 3xTF32 products emulated
  with float32 GEMMs (cuBLAS, TF32 off): it tells the split's dropped
  small*small term apart from the tensor cores' own float32 accumulation.

Run from a checkout's root:
``python fastspeech2_tpu_torch/tools/attention_bench.py --timings
--errors --split-sweep 1,2,4,8,16 [--root DIR] [--dtype bfloat16]
[--json FILE]``.
"""

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KERNEL_ATOL = 1e-4
# bfloat16 instances against their plain versions, as chip_smoke.py holds
# them
BF16_ULPS = 2
BATCH = 10
# (name, B, L, lengths or None for the training rows) of K1's path shapes
K1_SHAPES = (("readme_encoder", 1, 32, [31]), ("readme_decoder", 1, 1000,
                                                [253]),
             ("batch_encoder", 8, 128, None), ("batch_decoder", 8, 1000, None),
             ("serve_encoder", 16, 128, None),
             ("serve_decoder", 16, 1000, None),
             ("train_encoder", BATCH, 128, None),
             ("train_bucket768", BATCH, 768, None),
             ("train_decoder", BATCH, 1000, None))
# (heads, L) of K3's training shapes at batch 10: two heads, and one head a
# rank under tensor parallel 2
K3_SHAPES = ((2, 128), (2, 768), (2, 1000), (1, 128), (1, 1000))


def cuda_time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3):
    """fn's device time per call in ms: the durations of the kernels it
    launched (torch.profiler's CUDA activity) over ``iters`` calls after
    ``warmup``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / iters / 1e3


def inputs(B, L, lens, seed, device):
    """[B, 2, L, 128] q, k, v, g and a [B, L] key-pad mask; without
    ``lens``, rows of length L, 0 and random lengths in [L/2, L)."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    if lens is None:
        lens = [L, 0] + torch.randint(L // 2, L, (B - 2,),
                                      generator=gen).tolist()
    q, k, v, g = (torch.randn(B, 2, L, 128, generator=gen).to(device)
                  for _ in range(4))
    mask = (torch.arange(L)[None, :] >= torch.tensor(lens)[:, None]).to(
        device)
    return q, k, v, g, mask


def additive(mask):
    import torch

    return torch.zeros(mask.shape[0], 1, 1, mask.shape[1],
                       device=mask.device).masked_fill(
                           mask[:, None, None, :], -1e9)


def timings(attn, plain, dtype="float32"):
    """K1 and K3 against plain and SDPA at the path shapes, at ``dtype``."""
    import torch
    import torch.nn.functional as F

    dt = getattr(torch, dtype)
    rows = []
    for name, B, L, lens in K1_SHAPES:
        q, k, v, g, mask = inputs(B, L, lens, seed=L + B, device="cuda")
        q, k, v, g = (t.to(dt) for t in (q, k, v, g))
        bias = additive(mask).to(dt)
        if not name.startswith("train"):   # inference: no statistics
            kernel = lambda: attn.fused_attention(q, k, v, mask)  # noqa: E731
        else:        # training: the statistics K3 reads
            kernel = lambda: attn._launch_forward(  # noqa: E731
                q, k, v, mask, True)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=bias)
        rows.append(dict(
            kernel="K1", shape=[B, 2, L, 128], path=name, dtype=dtype,
            ms=cuda_time_ms(kernel), device_ms=device_ms(kernel),
            plain_ms=cuda_time_ms(
                lambda: plain.multi_head_attention(q, k, v, mask)),
            sdpa_ms=cuda_time_ms(sdpa), sdpa_device_ms=device_ms(sdpa)))
    for H, L in K3_SHAPES:
        q, k, v, g, mask = inputs(BATCH, L, None, seed=L, device="cuda")
        q, k, v, g = (t[:, :H].contiguous().to(dt) for t in (q, k, v, g))
        out, row_max, row_sum = attn._launch_forward(q, k, v, mask, True)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(
            *leaves, attn_mask=additive(mask).to(dt))
        kernel = lambda: attn.fused_attention_backward(  # noqa: E731
            q, k, v, mask, out, row_max, row_sum, g)
        sdpa = lambda: torch.autograd.grad(  # noqa: E731
            sdpa_out, leaves, g, retain_graph=True)
        rows.append(dict(
            kernel="K3", shape=[BATCH, H, L, 128],
            path="train" if H == 2 else "train_tp2", dtype=dtype,
            ms=cuda_time_ms(kernel), device_ms=device_ms(kernel),
            plain_ms=cuda_time_ms(lambda: plain.plain_attention_backward(
                q, k, v, mask, g)),
            sdpa_ms=cuda_time_ms(sdpa), sdpa_device_ms=device_ms(sdpa)))
        del sdpa_out, leaves
    return rows


def build_variant(cuda_build, chunks):
    """K1's two sources (attention.cu answers the plan for both dtypes)
    alone, their key-chunk count fixed at ``chunks``."""
    out_dir = os.path.join(cuda_build.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libattention_c{chunks}.so")
    nvcc = cuda_build._nvcc()
    compiles, objs = [], []
    for src in ("attention.cu", "attention_bf16.cu"):
        obj = os.path.join(out_dir, f"{src[:-3]}_c{chunks}.o")
        compiles.append([nvcc, *cuda_build.NVCC_FLAGS,
                         f"-DFS2_MHA_FWD_CHUNKS={chunks}", "-c",
                         os.path.join(cuda_build.CSRC_DIR, src), "-o", obj])
        objs.append(obj)
    return compiles, [nvcc, "-shared", "-gencode",
                      "arch=compute_90a,code=sm_90a", *objs, "-o", lib], lib


def bf16_ulps(got, ref):
    """max |got - ref| in ulps of bfloat16 at the largest |ref|."""
    ref = ref.float()
    unit = 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)
    return (got.float() - ref).abs().max().item() / unit


def split_sweep(attn, plain, cuda_build, counts, dtype="float32"):
    """K1 at its path shapes for each fixed chunk count, at ``dtype``."""
    import torch

    dt = getattr(torch, dtype)
    bf16 = dt == torch.bfloat16
    entry = "fs2_mha_fwd_bf16" if bf16 else "fs2_mha_fwd_f32"
    builds = [build_variant(cuda_build, c) for c in counts]
    procs = [[subprocess.Popen(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for cmd in compiles] for compiles, _, _ in builds]
    libs = {}
    for c, ps, (_, link_cmd, path) in zip(counts, procs, builds):
        for proc in ps:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {c} chunks:\n{out}")
        subprocess.run(link_cmd, check=True, capture_output=True)
        lib = ctypes.CDLL(path)
        getattr(lib, entry).argtypes = ([ctypes.c_void_p] * 8
                                        + [ctypes.c_int] * 4
                                        + [ctypes.c_float, ctypes.c_void_p])
        lib.fs2_mha_fwd_plan.argtypes = [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.fs2_mha_fwd_plan.restype = ctypes.c_longlong
        libs[c] = lib
    rows = []
    for name, B, L, lens in K1_SHAPES:
        q, k, v, _, mask = inputs(B, L, lens, seed=L + B, device="cuda")
        q, k, v = (t.to(dt) for t in (q, k, v))
        ref = plain.multi_head_attention(q, k, v, mask)
        rule = attn.forward_plan(B, 2, L, dt)[0]
        row = dict(shape=[B, 2, L, 128], path=name, dtype=dtype,
                   rule_grid=list(rule), variants=[])
        for c, lib in libs.items():
            grid = (ctypes.c_int * 3)()
            n = lib.fs2_mha_fwd_plan(B, 2, L, int(bf16), 0, grid)
            scratch = torch.empty(max(n, 1), device="cuda")
            out = torch.empty_like(q)
            row_max = torch.empty(B, 2, L, device="cuda")
            row_sum = torch.empty_like(row_max)
            stream = torch.cuda.current_stream().cuda_stream

            def launch():
                err = getattr(lib, entry)(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    mask.data_ptr(), out.data_ptr(),
                    row_max.data_ptr() if B > 1 else None,
                    row_sum.data_ptr() if B > 1 else None,
                    scratch.data_ptr(), B, 2, L, 128, 1.0 / math.sqrt(128),
                    stream)
                if err:
                    raise RuntimeError(f"{entry}: CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if bf16 and not bf16_ulps(out, ref) <= BF16_ULPS:
                raise RuntimeError(f"K1 bfloat16 with {c} chunks disagrees "
                                   f"with plain at {row['shape']}: "
                                   f"{bf16_ulps(out, ref):.2f} ulps")
            if not bf16 and not err <= KERNEL_ATOL:
                raise RuntimeError(f"K1 with {c} chunks disagrees with plain "
                                   f"at {row['shape']}: {err:.3e}")
            row["variants"].append(dict(chunks=c, grid=list(grid),
                                        ms=cuda_time_ms(launch),
                                        max_abs_err=err))
        rows.append(row)
    return rows


def errors(attn, plain):
    """K1's and K3's errors against float64, beside plain float32 and the
    3xTF32 products emulated with float32 GEMMs."""
    import torch

    L = 1000
    q, k, v, g, mask = inputs(BATCH, L, None, seed=L + 17, device="cuda")
    scale = 1.0 / math.sqrt(128)

    def tf32(x):   # cvt.rna on the bit pattern
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    def mm3(a, b):   # a @ b as big*small + small*big + big*big
        ab, bb = tf32(a), tf32(b)
        as_, bs = tf32(a - ab), tf32(b - bb)
        return ab @ bs + as_ @ bb + ab @ bb

    def emulated(q, k, v, g):
        s = (mm3(q, k.transpose(-1, -2)) * scale).masked_fill(
            mask[:, None, None, :], -1e9)
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        l_ = e.sum(-1, keepdim=True)
        out = mm3(e, v) / l_
        p = e / l_
        dv = mm3(p.transpose(-1, -2), g)
        dp = mm3(g, v.transpose(-1, -2))
        ds = p * (dp - (g * out).sum(-1, keepdim=True))
        dq = mm3(ds, k) * scale
        dk = mm3(ds.transpose(-1, -2), q) * scale
        return out, (dq, dk, dv)

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        d64 = [t.double() for t in (q, k, v, g)]
        ref_out = plain.multi_head_attention(*d64[:3], mask)
        ref_grads = plain.plain_attention_backward(*d64[:3], mask, d64[3])
        out, row_max, row_sum = attn._launch_forward(q, k, v, mask, True)
        versions = {
            "kernel": (out, attn.fused_attention_backward(
                q, k, v, mask, out, row_max, row_sum, g)),
            "plain float32": (plain.multi_head_attention(q, k, v, mask),
                              plain.plain_attention_backward(q, k, v, mask,
                                                             g)),
            "3xTF32 emulated, float32 GEMMs": emulated(q, k, v, g),
        }
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    rows = []
    for name, (o, grads) in versions.items():
        rows.append(dict(
            version=name,
            k1_max_abs_err=(o.double() - ref_out).abs().max().item(),
            k3_max_rel_err=max(
                ((a.double() - b).abs().max() / b.abs().max()).item()
                for a, b in zip(grads, ref_grads))))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose fastspeech2_tpu_torch is timed")
    ap.add_argument("--timings", action="store_true")
    ap.add_argument("--split-sweep", default="",
                    help="comma-separated fixed key-chunk counts for K1")
    ap.add_argument("--errors", action="store_true")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32",
                    help="the kernels' instance --timings and "
                         "--split-sweep time")
    ap.add_argument("--json", default=None, help="also write results here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("attention_bench: no CUDA card")
    sys.path.insert(0, os.path.abspath(args.root))
    from fastspeech2_tpu_torch.ops import attention as plain
    from fastspeech2_tpu_torch.ops import cuda_attention as attn
    from fastspeech2_tpu_torch.ops import cuda_build

    if not attn.__file__.startswith(os.path.abspath(args.root) + os.sep):
        sys.exit(f"attention_bench: imported {attn.__file__}, not the port "
                 f"in {args.root} (run this file, not the module)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    result = dict(root=os.path.abspath(args.root), card=card)
    print(f"[bench] {card}; port from {result['root']}", flush=True)
    if args.timings:
        result["timings"] = timings(attn, plain, args.dtype)
        for r in result["timings"]:
            dev = (f" (device {r['device_ms']:.4f} ms; SDPA's "
                   f"{r['sdpa_device_ms']:.4f} ms)" if "device_ms" in r
                   else "")
            print(f"[bench] {r['kernel']} {r['dtype']} {r['shape']} "
                  f"({r['path']}): "
                  f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"SDPA {r['sdpa_ms']:.4f} ms{dev}", flush=True)
    if args.split_sweep:
        counts = [int(c) for c in args.split_sweep.split(",")]
        result["split_sweep"] = split_sweep(attn, plain, cuda_build, counts,
                                            args.dtype)
        for r in result["split_sweep"]:
            cells = ", ".join(f"{x['chunks']}: {x['ms']:.4f}"
                              for x in r["variants"])
            print(f"[bench] K1 {r['dtype']} {r['shape']} ({r['path']}) ms "
                  f"by fixed chunk "
                  f"count {{{cells}}}; the rule's grid {r['rule_grid']}",
                  flush=True)
    if args.errors:
        result["errors"] = errors(attn, plain)
        for r in result["errors"]:
            print(f"[bench] [10, 2, 1000, 128] against float64, "
                  f"{r['version']}: K1 max_abs_err "
                  f"{r['k1_max_abs_err']:.3e}, K3 max error relative to the "
                  f"largest |grad| {r['k3_max_rel_err']:.3e}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
