"""Time and check the convolution kernels K4 (the MRF ResBlock) and K2 (the
conv FFN) on a CUDA card.

Three parts, each optional:

- ``--timings``: K4 at the 12 ResBlock shapes of a 1000-frame parity
  forward (``--batch 1``, the default; at ``--batch B`` > 1 the six shapes
  of the iSTFT vocoder, [B, 256, 8000] and [B, 128, 64000], as serving
  runs them at B = 16) and K2 at every shape of the port's paths ([1,
  32|1000|1536, 256] for the README sentence and the re-dispatch bucket,
  [10, 128|1000, 256] for the validation forward), beside the plain
  versions (cuDNN at the inference path's settings) and, for K4, cuDNN's
  chain autotuned (``cudnn.benchmark``, TF32 off); CUDA events over 20
  calls after 3 warm-up calls (5 after 1 at B > 1), as ``chip_smoke.py``
  times them.  For K4 also the device time per call from
  ``torch.profiler`` (the kernels alone, no host time): K4's launches, and
  the autotuned chain's convolution kernels and all its kernels.  ``--root DIR`` times the kernels of the
  port in another checkout (for example an unpacked parent commit): its
  ``fastspeech2_tpu_torch`` is imported instead of this one, and built
  there.  ``--dtype bfloat16`` times K2's bfloat16 instance (x in
  bfloat16; K4 has none: the vocoder stays float32).
- ``--sweep``: K4 at its 12 shapes by output channels per block (every
  power of two from 32 to C; the model takes ``n_block``'s), and K2's plan
  at the paths' small shapes ([1, 1|32|1000, 256], [1, 48, 256] with a
  3-tap second conv, [10, 128, 256]; at ``--dtype bfloat16`` also [1,
  1536], [2|8|10|16, 1000] and [16, 128]) by tap splits of the first conv
  and hidden groups of the second, each held against the plain version
  and timed by CUDA events and by device time per kernel (the data the
  plans' cost models in ``csrc/conv_ffn_f32.cu`` and ``csrc/conv_ffn.cu``
  are fitted to), the plan's own pick marked.
- ``--profile``: the device time of each kernel a call launches (K2's
  three launches, K4's per dilation unit), from ``torch.profiler`` over 20
  calls, at K2's README shapes and K4's widest and narrowest shapes.
- ``--errors``: K4 at its 12 shapes and K2 at [1, 1000, 256], the error
  against a float64 evaluation of the same function, beside that of the
  plain float32 version and of the 3xTF32 products emulated with float32
  convolutions (cuDNN, TF32 off): the split's dropped small*small term
  against the tensor cores' own float32 accumulation.

Run from a checkout's root: ``python fastspeech2_tpu_torch/tools/conv_bench.py
--timings --sweep --profile --errors [--batch B] [--root DIR] [--dtype
bfloat16] [--json FILE]``.
"""

import argparse
import functools
import inspect
import itertools
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DILATIONS = (1, 3, 5)
K4_RTOL = 1e-4
KERNEL_ATOL = 1e-4
# K2's bfloat16 instance against its plain version, as chip_smoke.py holds it
BF16_ULPS = 2
# K2's shapes: (B, L, k2) of the README sentence's encoder and decoder,
# the re-dispatch bucket, one frame, a 3-tap second conv, the validation
# forward at batch 10, batch mode's batch 8 and serving's batch 16
K2_SHAPES = ((1, 32, 1), (1, 1000, 1), (1, 1536, 1), (1, 1, 1), (1, 48, 3),
             (10, 128, 1), (10, 1000, 1), (8, 128, 1), (8, 1000, 1),
             (16, 128, 1), (16, 1000, 1))
# the HiFi-GAN-iSTFT C8C8I vocoder's ResBlocks (upsample rates 8, 8 from 512
# channels): the first six of the parity forward's twelve
ISTFT_CHANNELS = (256, 128)


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


def resblock_inputs(C, L, k, seed, device="cuda", B=1):
    """x [B, C, L] and three dilation units of Conv1d weights scaled to keep
    the output O(1), biases of 0.5 (as chip_smoke.py makes them)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    scale = (C * k) ** -0.5

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(device)

    x = r(B, C, L)
    w1, w2 = ([r(C, C, k, s=scale) for _ in DILATIONS] for _ in range(2))
    b1, b2 = ([r(C, s=0.5) for _ in DILATIONS] for _ in range(2))
    return x, w1, b1, w2, b2


def device_ms(fn, calls=5, warmup=1):
    """-> {kernel name: device ms per call} of ``calls`` calls of fn after
    ``warmup`` calls, from torch.profiler: the kernels' own events only, not
    the CPU-side ops that launched them (whose device time is their
    kernels', counted again)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0):
            kernels[e.key] = (kernels.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3 / calls)
    return kernels


def k4_device_times(resblock, rb, packed):
    """K4's and the autotuned cuDNN chain's device ms per call: K4's
    launches, the chain's convolutions (every kernel but PyTorch's
    elementwise ones: the leaky ReLUs, the residual adds) and all its
    kernels."""
    import torch

    k4 = device_ms(lambda: resblock.fused_resblock(*rb, DILATIONS,
                                                   packed=packed))
    with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                    deterministic=False, allow_tf32=False):
        chain = device_ms(lambda: resblock.plain_resblock(*rb, DILATIONS))
    return dict(
        device_ms=sum(ms for n, ms in k4.items() if "resblock" in n),
        cudnn_conv_device_ms=sum(ms for n, ms in chain.items()
                                 if "elementwise" not in n),
        cudnn_device_ms=sum(chain.values()))


def ffn_inputs(B, L, seed, device="cuda", k2=1):
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g) * scale + shift).to(device)

    return (r(B, L, 256), r(9, 256, 1024, scale=0.03), r(1024, scale=0.1),
            r(k2, 1024, 256, scale=0.03), r(256, scale=0.1),
            r(256, scale=0.1, shift=1.0), r(256, scale=0.1))


def ffn_kernel_call(ffn, args):
    """K2 as the model calls it: with its weight pack made once (at x's
    dtype), where the port has one."""
    if "packed" in inspect.signature(ffn.fused_conv_ffn).parameters:
        if args[0].dtype != args[1].dtype:   # the bfloat16 instance
            packed = ffn.pack_ffn_weights(args[1], args[3], args[0].dtype)
        else:
            packed = ffn.pack_ffn_weights(args[1], args[3])
        return lambda: ffn.fused_conv_ffn(*args, packed=packed)
    return lambda: ffn.fused_conv_ffn(*args)


def k4_shapes(bounds, batch):
    """(C, L, k) K4 is timed at: the parity forward's 12 at batch 1, the
    iSTFT vocoder's 6 at a larger batch."""
    shapes = bounds.parity_resblock_shapes(1000)
    return shapes if batch == 1 else [s for s in shapes
                                      if s[0] in ISTFT_CHANNELS]


def timings(resblock, ffn, bounds, dtype="float32", batch=1):
    """K4 (float32) and K2 at ``dtype`` against their plain versions."""
    import torch

    rows = []
    iters = dict(iters=20, warmup=3) if batch == 1 else dict(iters=5,
                                                             warmup=1)
    for C, L, k in (k4_shapes(bounds, batch) if dtype == "float32" else ()):
        rb = resblock_inputs(C, L, k, seed=C + k, B=batch)
        packed = resblock.pack_resblock_weights(*rb[1:])
        with torch.inference_mode():
            row = dict(
                kernel="K4", shape=[batch, C, L], k=k,
                ms=cuda_time_ms(lambda: resblock.fused_resblock(
                    *rb, DILATIONS, packed=packed), **iters),
                plain_ms=cuda_time_ms(lambda: resblock.plain_resblock(
                    *rb, DILATIONS), **iters))
            with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                            deterministic=False,
                                            allow_tf32=False):
                row["cudnn_autotuned_ms"] = cuda_time_ms(
                    lambda: resblock.plain_resblock(*rb, DILATIONS),
                    **iters)
            row.update(k4_device_times(resblock, rb, packed))
            row["bound_ms"] = bounds.resblock_bound_ms(batch, L, C, k)[0]
        rows.append(row)
        del rb, packed
        torch.cuda.empty_cache()
    for B, L, k2 in K2_SHAPES if batch == 1 else ():
        args = ffn_inputs(B, L, seed=L + B, k2=k2)
        args = (args[0].to(getattr(torch, dtype)),) + args[1:]
        with torch.inference_mode():
            call = ffn_kernel_call(ffn, args)
            rows.append(dict(
                kernel="K2", shape=[B, L, 256], k2=k2, dtype=dtype,
                ms=cuda_time_ms(call),
                device_ms=sum(device_ms(call, calls=20, warmup=3).values()),
                plain_ms=cuda_time_ms(lambda: ffn.plain_conv_ffn(*args)),
                bound_ms=bounds.ffn_bound_ms(B, L, taps=(9, k2),
                                             dtype=dtype)[0]))
    return rows


def bf16_ulps(got, ref):
    """max |got - ref| in ulps of bfloat16 at the largest |ref|."""
    import math

    unit = 2.0 ** (math.floor(math.log2(ref.float().abs().max().item())) - 7)
    return (got.float() - ref.float()).abs().max().item() / unit


def sweep(resblock, ffn, bounds, dtype="float32"):
    """K4 by output channels per block (float32 only); K2 at ``dtype`` by
    its plan (tap splits, hidden groups)."""
    import torch

    rows = []
    for C, L, k in (bounds.parity_resblock_shapes(1000)
                    if dtype == "float32" else ()):
        rb = resblock_inputs(C, L, k, seed=C + k)
        packed = resblock.pack_resblock_weights(*rb[1:])
        with torch.inference_mode():
            ref = resblock.plain_resblock(*rb, DILATIONS)
            for nb in (32, 64, 128, 256):
                if nb > C:
                    continue

                def run():
                    return resblock._launch(rb[0], packed, DILATIONS, nb)
                err = (run() - ref).abs().max().item()
                if not err <= K4_RTOL * ref.abs().max().item():
                    raise RuntimeError(f"K4 nb {nb} at {[C, L, k]}: "
                                       f"{err:.3e}")
                rows.append(dict(kernel="K4", shape=[1, C, L], k=k, nb=nb,
                                 ms=cuda_time_ms(run), max_abs_err=err))
    dt = getattr(torch, dtype)
    shapes = ((1, 1, 1), (1, 32, 1), (1, 48, 3), (1, 1000, 1), (10, 128, 1))
    if dtype == "bfloat16":   # its plan also splits the large shapes
        shapes += ((1, 1536, 1), (2, 1000, 1), (8, 1000, 1), (10, 1000, 1),
                   (16, 128, 1), (16, 1000, 1))
    groups = (1, 2, 4, 8, 16, 32) if dtype == "float32" else (1, 2, 4, 8, 16)
    for B, L, k2 in shapes:
        args = ffn_inputs(B, L, seed=L + B, k2=k2)
        args = (args[0].to(dt),) + args[1:]
        packed = ffn.pack_ffn_weights(args[1], args[3], dt)
        ref = ffn.plain_conv_ffn(*args)
        own = ffn.forward_plan(B, L, 1024, 9, k2, dt)
        for plan in itertools.product((1, 3, 9), groups):
            def run():
                return ffn._launch(*args, packed=packed, plan=plan)
            if dtype == "float32":
                err = (run() - ref).abs().max().item()
                bad = not err <= KERNEL_ATOL
            else:
                err = bf16_ulps(run(), ref)
                bad = not err <= BF16_ULPS
            if bad:
                raise RuntimeError(f"K2 plan {plan} at {[B, L]}: {err:.3e}")
            kernels = device_ms(run)
            rows.append(dict(kernel="K2", shape=[B, L, 256], k2=k2,
                             dtype=dtype, splits=plan[0], groups=plan[1],
                             the_plans=plan == own, ms=cuda_time_ms(run),
                             device_ms=sum(kernels.values()),
                             device_ms_by_kernel=kernels, max_abs_err=err))
    return rows


def profile(resblock, ffn):
    """-> [{call, shape, kernels: {name: device ms per call}}]."""
    import torch

    calls = []
    for B, L in ((1, 32), (1, 1000)):
        args = ffn_inputs(B, L, seed=L + B)
        calls.append(("K2", [B, L, 256], ffn_kernel_call(ffn, args)))
    for C, L, k in ((256, 8000, 3), (128, 64000, 11), (32, 256000, 3)):
        rb = resblock_inputs(C, L, k, seed=C + k)
        packed = resblock.pack_resblock_weights(*rb[1:])
        calls.append(("K4", [1, C, L, k], functools.partial(
            resblock.fused_resblock, *rb, DILATIONS, packed=packed)))
    rows = []
    for name, shape, fn in calls:
        with torch.inference_mode():
            kernels = device_ms(fn, calls=20, warmup=3)
        rows.append(dict(call=name, shape=shape, kernels={
            n[:60]: ms for n, ms in kernels.items()}))
    return rows


def errors(resblock, ffn, bounds):
    """The kernels' errors against float64, beside plain float32 and the
    3xTF32 products emulated with float32 convolutions."""
    import torch
    import torch.nn.functional as F

    def tf32(x):   # cvt.rna on the bit pattern
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    def conv3(x, w, **kw):   # x (*) w as big*small + small*big + big*big
        xb, wb = tf32(x), tf32(w)
        xs, ws = tf32(x - xb), tf32(w - wb)
        return (F.conv1d(xb, ws, **kw) + F.conv1d(xs, wb, **kw)
                + F.conv1d(xb, wb, **kw))

    def emulated_resblock(x, w1, b1, w2, b2):
        for u, d in enumerate(DILATIONS):
            k = w1[u].shape[-1]
            t = conv3(F.leaky_relu(x, 0.1), w1[u], padding=(k * d - d) // 2,
                      dilation=d) + b1[u][:, None]
            t = conv3(F.leaky_relu(t, 0.1), w2[u],
                      padding=(k - 1) // 2) + b2[u][:, None]
            x = x + t
        return x

    rows = []
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=False,
            allow_tf32=False):
        for C, L, k in bounds.parity_resblock_shapes(1000):
            rb = resblock_inputs(C, L, k, seed=C + k + 1)
            ref = resblock.plain_resblock(
                *[t.double() if torch.is_tensor(t) else [v.double() for v in t]
                  for t in rb], DILATIONS)
            scale = ref.abs().max().item()
            versions = {
                "kernel": resblock.fused_resblock(*rb, DILATIONS),
                "plain float32": resblock.plain_resblock(*rb, DILATIONS),
                "3xTF32 emulated, float32 convs": emulated_resblock(*rb),
            }
            rows.append(dict(kernel="K4", shape=[1, C, L], k=k, errors={
                name: (v.double() - ref).abs().max().item() / scale
                for name, v in versions.items()}))
        args = ffn_inputs(1, 1000, seed=17)
        ref = ffn.plain_conv_ffn(*[a.double() for a in args])
        rows.append(dict(kernel="K2", shape=[1, 1000, 256], errors={
            "kernel": (ffn_kernel_call(ffn, args)().double() - ref
                       ).abs().max().item(),
            "plain float32": (ffn.plain_conv_ffn(*args).double() - ref
                              ).abs().max().item()}))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose fastspeech2_tpu_torch is timed")
    ap.add_argument("--timings", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--errors", action="store_true")
    ap.add_argument("--batch", type=int, default=1,
                    help="K4's batch in --timings (1: the 12 parity "
                         "shapes and K2; more: the 6 iSTFT shapes)")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32",
                    help="K2's instance --timings and --sweep time "
                         "(bfloat16: K2 only)")
    ap.add_argument("--json", default=None, help="also write results here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("conv_bench: no CUDA card")
    sys.path.insert(0, os.path.abspath(args.root))
    from fastspeech2_tpu_torch.ops import cuda_ffn as ffn
    from fastspeech2_tpu_torch.ops import cuda_resblock as resblock
    from fastspeech2_tpu_torch.tools import kernel_bounds as bounds
    from fastspeech2_tpu_torch.utils.device import resolve_device

    if not resblock.__file__.startswith(os.path.abspath(args.root) + os.sep):
        sys.exit(f"conv_bench: imported {resblock.__file__}, not the port "
                 f"in {args.root} (run this file, not the module)")
    resolve_device("cuda")   # pins TF32 off, as the port's entry points do
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    result = dict(root=os.path.abspath(args.root), card=card)
    print(f"[bench] {card}; port from {result['root']}", flush=True)
    if args.timings:
        result["timings"] = timings(resblock, ffn, bounds, args.dtype,
                                    args.batch)
        for r in result["timings"]:
            extra = (f", cuDNN autotuned {r['cudnn_autotuned_ms']:.4f} ms; "
                     f"device ms: kernel {r['device_ms']:.4f}, cuDNN "
                     f"convolutions {r['cudnn_conv_device_ms']:.4f} (all "
                     f"{r['cudnn_device_ms']:.4f}); bound "
                     f"{r['bound_ms']:.4f} ms"
                     if "cudnn_autotuned_ms" in r else
                     f"; device {r['device_ms']:.4f} ms, bound "
                     f"{r['bound_ms']:.4f} ms "
                     f"({r['bound_ms'] / r['device_ms']:.1%})")
            k = (f" k={r['k']}" if "k" in r
                 else f" k2={r['k2']} {r['dtype']}")
            print(f"[bench] {r['kernel']} {r['shape']}{k}: kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms{extra}",
                  flush=True)
        k4 = [r for r in result["timings"] if r["kernel"] == "K4"]
        istft = [r for r in k4 if r["shape"][1] in ISTFT_CHANNELS]
        for name, rows in (("the 12 parity calls", k4 if args.batch == 1
                            else []),
                           ("the iSTFT vocoder's 6 shapes", istft)):
            if not rows:
                continue
            print(f"[bench] K4 summed over {name} at batch {args.batch}: "
                  f"kernel {sum(r['ms'] for r in rows):.4f} ms (device "
                  f"{sum(r['device_ms'] for r in rows):.4f}), plain (cuDNN "
                  f"at the inference settings) "
                  f"{sum(r['plain_ms'] for r in rows):.4f} ms, cuDNN "
                  f"autotuned "
                  f"{sum(r['cudnn_autotuned_ms'] for r in rows):.4f} ms "
                  f"(device, convolutions "
                  f"{sum(r['cudnn_conv_device_ms'] for r in rows):.4f}), "
                  f"bound {sum(r['bound_ms'] for r in rows):.4f} ms",
                  flush=True)
    if args.sweep:
        result["sweep"] = sweep(resblock, ffn, bounds, args.dtype)
        for r in result["sweep"]:
            what = (f"{r['nb']} output channels per block"
                    if r["kernel"] == "K4" else
                    f"splits {r['splits']} groups {r['groups']}"
                    f"{' (the plan)' if r['the_plans'] else ''}, device "
                    f"{r['device_ms']:.4f} ms")
            k = (f" k={r['k']}" if "k" in r else f" k2={r['k2']}"
                 if "k2" in r else "")
            err = ("ulps of bfloat16" if r.get("dtype") == "bfloat16"
                   else "max_abs_err")
            print(f"[bench] sweep {r['kernel']} {r['shape']}{k} {what}: "
                  f"{r['ms']:.4f} ms ({err} {r['max_abs_err']:.2e})",
                  flush=True)
    if args.profile:
        result["profile"] = profile(resblock, ffn)
        for r in result["profile"]:
            cells = ", ".join(f"{n} {ms:.4f}" for n, ms in
                              sorted(r["kernels"].items()))
            print(f"[bench] profile {r['call']} {r['shape']}: device ms per "
                  f"call by kernel: {cells}", flush=True)
    if args.errors:
        result["errors"] = errors(resblock, ffn, bounds)
        for r in result["errors"]:
            cells = ", ".join(f"{key} {err:.3e}"
                              for key, err in r["errors"].items())
            scale = ("relative to the largest |output|" if r["kernel"] == "K4"
                     else "absolute")
            k = f" k={r['k']}" if "k" in r else ""
            print(f"[bench] {r['kernel']} {r['shape']}{k} against float64 "
                  f"({scale}): {cells}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
