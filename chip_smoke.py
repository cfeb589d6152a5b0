#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fastspeech2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing flushed lines (a failing phase raises, and the run
exits non-zero):

1. card      the GPU's name and power limit, as nvidia-smi prints them;
2. build     nvcc builds the port's CUDA kernels from csrc/ (about a
             minute); every kernel's registers and spills over all its
             template instances (a spill fails the run), K1's and K3's
             resident blocks per SM, every kernel's HMMA (tensor-core)
             instruction count in the SASS, K1's grid at batch 1 and K2's
             plan;
3. K1        the attention kernel against its plain version at the path's
             shapes, with partly and fully padded key rows;
4. K2        the conv-FFN kernel against its plain version at every path
             shape, each launched twice (bitwise equal);
5. K3        the attention-backward kernel against its plain version at the
             training shapes, and the autograd Function (K1 forward, K3
             backward) against autograd through the plain forward; K1 and
             K3 launched twice on the same inputs must agree bit for bit;
6. K4        the MRF ResBlock kernel against its plain version at the 12
             ResBlock shapes of a 1000-frame parity-vocoder forward (each
             launched twice, bitwise equal), at L = 8 (a 1-frame mel at
             C = 256) and at ragged L;
7. synthesis the README sentence, text -> wav, through the CLI's main with
             the tracked weights (HiFi-GAN-iSTFT); the kernels' launch
             counts over that run (6 K4 per iSTFT forward); the mel against
             the same forward with the plain versions, the iSTFT wav
             against the same vocoder with its plain ResBlocks;
8. parity    the same sentence through the CLI's main with
             config/LJSpeech/model.yaml: the parity HiFi-GAN from its seeded
             random init; launch counts (12 K4 per vocoder forward); the wav
             against the same vocoder forward with the plain ResBlocks;
           then the synthesize CLI's inference options, each through its
           main with the launch counts set to 0 just before and read just
           after (10 K1 + 10 K2 per acoustic forward throughout):
   melgan    vocoder.model MelGAN on its tracked snapshot (0 K4);
   griffin-lim  vocoder.model none: the card's Griffin-Lim against the
             CPU's from the same initial phase, and two card runs bitwise
             equal;
   batch     --mode batch over the corpus's 10 metadata rows (forwards at
             batch 8 and 2): each forward's mel against the same forward
             with the plain K1/K2, launches per forward, 10 wavs and 10
             pngs (or the line saying matplotlib is missing);
   long      --long on three sentences: the joined wav is the chunks plus
             the pauses;
   torch_ckpt  --torch_ckpt on the tracked weights as a reference-format
             .pth.tar: the wav bitwise equal to the --weights_npz run's;
   mandarin  tone-numbered pinyin with a language: zh config, and hanzi
             without pypinyin raising;
9. timings   each kernel, its plain version and the library yardstick
             (CUDA events; K1 and K2 also at batch mode's batch-8 shapes),
             text -> wav end to end, the parity vocoder's forward, and
             MelGAN's and Griffin-Lim's forward on the 1000-frame mel;
10. training 20 steps at full model width (config/LJSpeech10, batch 10) on
             a synthetic corpus through the port's train(), with one
             validation pass; launch counts per step and per eval forward;
             then a resume from the checkpoint through the train CLI;
11. synthesis from the trained checkpoint through the synthesize CLI's
             --restore_step;
12. repro    5 training steps twice from one seed through train(): every
             parameter must agree exactly;
13. kernels  one JSON line describing K1, K2, K3 and K4 and the bfloat16
             instances of K1, K2 and K3.

The bfloat16 instances (--dtype bfloat16, the JAX train CLI's default) run
through the same script: the build reports their registers, spills and
HMMA counts; after phase 5, K1, K2 and K3 at bfloat16 are held against
their plain versions at every path shape, each launched twice (bitwise
equal); after phase 8, the README sentence goes through the synthesize
CLI's main with --dtype bfloat16 (10 bfloat16 K1 and K2 per forward, no
float32 ones; the mel against the same forward with the plain versions);
phase 9 times the bfloat16 instances beside SDPA at bfloat16; after phase
12, the train CLI trains 20 steps at its default dtype (bfloat16; 10
bfloat16 K1 and K3 per step) and 5 steps twice from one seed must agree
exactly.

The last line is {"ok": true, "device": {...}}.  Outputs go to a temporary
directory.  Without a CUDA device, or outside a checkout of the repository,
the script exits non-zero before printing any result.
"""

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import wave

import yaml

README_SENTENCE = "The quick brown fox jumps over the lazy dog."
CONFIG = "config/LJSpeech10"
# differs from config/LJSpeech10/model.yaml only in vocoder.model: HiFi-GAN
PARITY_MODEL = "config/LJSpeech/model.yaml"
ACOUSTIC_NPZ = "weights/acoustic_LJSpeech10_100k.npz"
VOCODER_NPZ = "weights/vocoder_gen_mixed60k.npz"
MELGAN_NPZ = "weights/vocoder_melgan_30k.npz"
# batch mode reads the corpus's metadata: 10 rows, forwards at batch 8
# and 2 (the CLI's BATCH_SIZE)
BATCH_SOURCE = "preprocessed_data/LJSpeech10/train.txt"
LONG_TEXT = ("The quick brown fox jumps over the lazy dog. The soviet "
             "authorities denied oswald permission. They bought their "
             "offices from one another.")
PINYIN_TEXT = "ni3 hao3 shi4 jie4"
HANZI_TEXT = "你好世界"
# Griffin-Lim on the card against the CPU from the same initial phase:
# 30 rounds of float32 FFTs (cuFFT against PocketFFT), absolute on the
# float waveform, where 1.0 is int16 full scale (the README sentence's
# peaks near 3.8, and its int16 wav clips)
GL_ATOL = 1e-4
# float32 kernels vs float32 plain versions: the same sums in another
# order (up to 2304 terms for K2's first conv), so agreement to ~1e-5 of
# O(1) values is expected; 1e-4 leaves headroom
KERNEL_ATOL = 1e-4
# K3's gradients: float32 sums of up to 1000 terms in another order, held
# RELATIVE to the largest |gradient| of each output (dq, dk, dv)
K3_RTOL = 1e-4
# the mel after ten layers of both kernels and the PostNet
MEL_ATOL = 1e-3
# K4: float32 sums of up to 2816 terms through six convs, held RELATIVE to
# the largest |output|
K4_RTOL = 1e-4
# the parity wav in [-1, 1] after 12 K4 calls, four upsampling convs and
# tanh; 1e-4 is ~3 int16 steps
WAV_ATOL = 1e-4
DILATIONS = (1, 3, 5)
REPRO_STEPS = 5
# training: the decoder's and encoder's L at LJSpeech lengths
TRAIN_BATCH = 10
TRAIN_STEPS = 20
# every kernel's least time (tools/kernel_bounds.py: H100 SXM peaks from
# NVIDIA's data sheet)
BOUND_BASIS = ("3xTF32 on the tensor cores: max(3 x operations / 495 "
               "TFLOP/s, bytes / 3.35 TB/s)")
BOUND_BASIS_BF16 = ("BF16 on the tensor cores: max(operations / 989 "
                    "TFLOP/s, bytes of bfloat16 / 3.35 TB/s)")
BOUND_BASIS_K3_BF16 = ("BF16 for S and dP, 2xTF32 for the products with "
                       "P and dS (a float32 operand times a bfloat16 one): "
                       "max(2/5 x operations / 989 TFLOP/s + 2 x 3/5 x "
                       "operations / 495 TFLOP/s, bytes of bfloat16 / 3.35 "
                       "TB/s)")
# the bfloat16 instances against their plain versions, in ulps of bfloat16
# at the largest |plain value|: both round at the same points, and a
# float32 sum in another order may land on the other side of a rounding
# boundary (one ulp; K1 also rounds its unnormalised P where the plain
# version rounds the normalised one)
BF16_ULPS = 2
# the bfloat16 mel before and after the PostNet, after ten layers of both
# kernels, kernels against plain versions on one forward whose variance
# buckets are pinned: the rounding flips of each layer carried through the
# residual stream (the PostNet is the same code on both sides)
BF16_MEL_ULPS = 8
# the attention kernels' SASS functions: K1 and its key-split combine; K3a
# (D = rowsum(g * out)), K3b (dK, dV and the dQ partials), the dQ reduction
ATTENTION_KERNELS = ("mha_fwd_f32_kernel", "mha_fwd_combine_kernel",
                     "mha_bwd_rowdot_kernel", "mha_bwd_dkdv_kernel",
                     "mha_bwd_dq_reduce_kernel", "mha_fwd_bf16_kernel",
                     "mha_bwd_rowterm_bf16_kernel",
                     "mha_bwd_dkdv_bf16_kernel")
# the convolution kernels' SASS functions (templates: several instances
# each): K4's one-launch dilation unit and its two-launch conv, K2's two
# convs (its LayerNorm kernel does no product)
CONV_KERNELS = ("resblock_unit_kernel", "resblock_conv_kernel",
                "ffn_conv1_kernel", "ffn_conv2_kernel",
                "ffn_conv1_bf16_kernel", "ffn_conv2_bf16_kernel")
# the kernels that multiply, each of which must hold HMMA instructions
MMA_KERNELS = ("mha_fwd_f32_kernel", "mha_bwd_dkdv_kernel",
               "mha_fwd_bf16_kernel", "mha_bwd_rowterm_bf16_kernel",
               "mha_bwd_dkdv_bf16_kernel") + CONV_KERNELS
# K2's shapes on the paths: (B, L, k2) of the README sentence's encoder
# and decoder, the re-dispatch bucket, one frame, a 3-tap second conv, and
# the validation forward at batch 10
K2_SHAPES = ((1, 1000, 1), (1, 32, 1), (1, 1536, 1), (1, 1, 1), (1, 48, 3),
             (TRAIN_BATCH, 128, 1), (TRAIN_BATCH, 1000, 1))


def say(*parts):
    print(*parts, flush=True)


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


def with_bound(t, bound, basis=BOUND_BASIS):
    """t + the bound of one of tools/kernel_bounds.py's functions (3xTF32
    on the tensor cores unless ``basis`` names another), the SIMT float32
    bound beside it."""
    t["bound_ms"], t["bound_by"], t["simt_bound_ms"] = bound[:3]
    t["bound_basis"] = basis
    return t


def ptxas_by_kernel(report, names):
    """-> {kernel: {instances, max_registers, spill_bytes}} over all the
    template instances of each kernel, from nvcc -Xptxas -v."""
    out = {n: dict(instances=0, max_registers=0, spill_bytes=0)
           for n in names}
    current = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            current = next((n for n in names if n in line), None)
            if current:
                out[current]["instances"] += 1
        elif current and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out[current]["spill_bytes"] += nums[1] + nums[2]
        elif current and "Used" in line and "registers" in line:
            regs = int(line.split("Used")[1].split()[0])
            out[current]["max_registers"] = max(
                out[current]["max_registers"], regs)
    return out


def hmma_counts(lib_path, names):
    """-> {kernel: HMMA instructions in its SASS}, or None without
    cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        head = block.split("\n", 1)[0]
        name = next((n for n in names if n in head), None)
        if name:
            counts[name] = counts.get(name, 0) + sum(
                " HMMA." in ln for ln in block.splitlines())
    return counts


def attention_inputs(lens, L, device, seed):
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(len(lens), 2, L, 128, generator=g).to(device)
               for _ in range(3))
    mask = (torch.arange(L)[None, :] >= torch.tensor(lens)[:, None]).to(device)
    return q, k, v, mask


def attention_grad_inputs(L, device, seed, B=TRAIN_BATCH):
    """[B, 2, L, 128] q, k, v and g with one full row, one fully padded row
    and partly padded rows between."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    lens = [L, 0] + torch.randint(L // 2, L, (B - 2,), generator=g).tolist()
    q, k, v, mask = attention_inputs(lens, L, device, seed)
    grad = torch.randn(q.shape, generator=g).to(device)
    return q, k, v, mask, grad


def ffn_inputs(L, device, seed, k2=1, B=1):
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g) * scale + shift).to(device)

    return (r(B, L, 256), r(9, 256, 1024, scale=0.03), r(1024, scale=0.1),
            r(k2, 1024, 256, scale=0.03), r(256, scale=0.1),
            r(256, scale=0.1, shift=1.0), r(256, scale=0.1))


def resblock_inputs(C, L, k, device, seed, bias=0.5):
    """x [1, C, L] and three dilation units of Conv1d weights scaled to keep
    the output O(1); biases of 0.5 show a leak at the sequence edges."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    scale = (C * k) ** -0.5

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(device)

    x = r(1, C, L)
    w1, w2 = ([r(C, C, k, s=scale) for _ in DILATIONS] for _ in range(2))
    b1, b2 = ([r(C, s=bias) for _ in DILATIONS] for _ in range(2))
    return x, w1, b1, w2, b2


def launch_counts():
    """-> {kernel: launches so far} of the four wrappers, each dtype
    instance apart."""
    from fastspeech2_tpu_torch.ops import (
        cuda_attention,
        cuda_ffn,
        cuda_resblock,
    )

    return {"K1": cuda_attention.launches, "K2": cuda_ffn.launches,
            "K3": cuda_attention.bwd_launches, "K4": cuda_resblock.launches,
            "K1_bf16": cuda_attention.launches_bf16,
            "K2_bf16": cuda_ffn.launches_bf16,
            "K3_bf16": cuda_attention.bwd_launches_bf16}


def zero_counts():
    from fastspeech2_tpu_torch.ops import (
        cuda_attention,
        cuda_ffn,
        cuda_resblock,
    )

    cuda_attention.launches = cuda_attention.bwd_launches = 0
    cuda_ffn.launches = cuda_resblock.launches = 0
    cuda_attention.launches_bf16 = cuda_attention.bwd_launches_bf16 = 0
    cuda_ffn.launches_bf16 = 0


def bf16_ulps(got, ref):
    """max |got - ref| in ulps of bfloat16 at the largest |ref|."""
    import torch

    ref = ref.float()
    unit = 2.0 ** (torch.floor(torch.log2(ref.abs().max())).item() - 7)
    return (got.float() - ref).abs().max().item() / unit


@contextlib.contextmanager
def record_forwards():
    """Wrap ``Synthesizer.infer_ids`` (every acoustic forward of the CLI's
    modes goes through it): each call's arguments, output and the launches
    it made (one acoustic forward, or two with a re-dispatch)."""
    from fastspeech2_tpu_torch.synthesis.pipeline import Synthesizer

    calls = []
    inner = Synthesizer.infer_ids

    def infer_ids(self, *args, **kwargs):
        before = launch_counts()
        out = inner(self, *args, **kwargs)
        after = launch_counts()
        calls.append(dict(synth=self, args=args, kwargs=kwargs, out=out,
                          launches={k: after[k] - before[k]
                                    for k in after}))
        return out

    Synthesizer.infer_ids = infer_ids
    try:
        yield calls
    finally:
        Synthesizer.infer_ids = inner


def drive_cli(argv):
    """The synthesize CLI's main(argv), every launch count set to 0 just
    before and read just after -> (its return value, launches, the
    acoustic forwards, its printed lines, seconds)."""
    import torch

    from fastspeech2_tpu_torch.cli import synthesize_cli

    printed = io.StringIO()
    with record_forwards() as calls:
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            result = synthesize_cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
    return result, launches, calls, printed.getvalue().splitlines(), seconds


def batch_shapes(preprocess_config):
    """-> [(padded batch, encoder L, real rows)] of the batch-mode forwards
    over BATCH_SOURCE, as the CLI packs them (rows of 8, the batch padded to
    a power of two, phones to a multiple of 16)."""
    from fastspeech2_tpu_torch.cli.synthesize_cli import (
        BATCH_SIZE,
        load_metadata_rows,
    )
    from fastspeech2_tpu_torch.synthesis.pipeline import TEXT_BUCKET, round_up
    from fastspeech2_tpu_torch.text import text_to_sequence

    cleaners = preprocess_config["preprocessing"]["text"]["text_cleaners"]
    texts = load_metadata_rows(preprocess_config, BATCH_SOURCE)[2]
    lens = [len(text_to_sequence(t, cleaners)) for t in texts]
    return [(1 << (len(chunk) - 1).bit_length(),
             round_up(max(chunk), TEXT_BUCKET), len(chunk))
            for chunk in (lens[i:i + BATCH_SIZE]
                          for i in range(0, len(lens), BATCH_SIZE))]


def bf16_kernel_checks(device, bshapes, k2_shapes):
    """K1, K2 and K3 at bfloat16 against their plain versions on the card,
    at every path shape, each launched twice on the same inputs (bitwise
    equal): K1 at the README sentence's and batch mode's shapes and at the
    training shapes with the row statistics; K2 at every shape K2_SHAPES
    and batch mode give; K3 at the training shapes.  Raises on a failed
    gate -> {kernel: (largest error in ulps, largest absolute error)}."""
    import torch

    from fastspeech2_tpu_torch.ops import cuda_attention, cuda_ffn
    from fastspeech2_tpu_torch.ops.attention import (
        multi_head_attention,
        plain_attention_backward,
    )

    bf16 = torch.bfloat16
    found = {name: [0.0, 0.0] for name in ("K1", "K2", "K3")}
    repeat = {name: True for name in found}

    def record(name, got, again, ref, where):
        if not torch.isfinite(got.float()).all():
            raise RuntimeError(f"{name} bfloat16 output not finite at "
                               f"{where}")
        repeat[name] = repeat[name] and torch.equal(got, again)
        found[name][0] = max(found[name][0], bf16_ulps(got, ref))
        found[name][1] = max(found[name][1],
                             (got.float() - ref.float()).abs().max().item())

    k1_shapes = ([(L, lens) for L, partial in ((32, 31), (48, 33),
                                               (1000, 253))
                  for lens in ([partial], [L, 0])]
                 + [(L, B) for B, enc, _ in bshapes for L in (enc, 1000)])
    for L, lens in k1_shapes:
        if isinstance(lens, int):
            q, k, v, mask, _ = attention_grad_inputs(L, device, seed=L + lens,
                                                     B=lens)
        else:
            q, k, v, mask = attention_inputs(lens, L, device, seed=L)
        q, k, v = (t.to(bf16) for t in (q, k, v))
        got = cuda_attention.fused_attention(q, k, v, mask)
        again = cuda_attention.fused_attention(q, k, v, mask)
        torch.cuda.synchronize()
        record("K1", got, again, multi_head_attention(q, k, v, mask),
               f"[{q.shape[0]}, 2, {L}, 128]")
    for L in (1000, 768, 128):
        q, k, v, mask, g = (t.to(bf16) if t.is_floating_point() else t
                            for t in attention_grad_inputs(L, device,
                                                           seed=L + 21))
        fwd = [cuda_attention._launch_forward(q, k, v, mask, True)
               for _ in range(2)]
        bwd = [cuda_attention.fused_attention_backward(q, k, v, mask,
                                                       *fwd[0], g)
               for _ in range(2)]
        torch.cuda.synchronize()
        where = f"[{TRAIN_BATCH}, 2, {L}, 128]"
        record("K1", fwd[0][0], fwd[1][0], multi_head_attention(q, k, v,
                                                                mask), where)
        repeat["K1"] = repeat["K1"] and all(
            torch.equal(a, b) for a, b in zip(fwd[0][1:], fwd[1][1:]))
        for a, b, ref in zip(*bwd, plain_attention_backward(q, k, v, mask,
                                                            g)):
            record("K3", a, b, ref, where)
    for B, L, k2 in k2_shapes:
        args = ffn_inputs(L, device, seed=L + k2 + B + 1, k2=k2, B=B)
        args = (args[0].to(bf16),) + args[1:]
        got = cuda_ffn.fused_conv_ffn(*args)
        again = cuda_ffn.fused_conv_ffn(*args)
        torch.cuda.synchronize()
        record("K2", got, again, cuda_ffn.plain_conv_ffn(*args),
               f"[{B}, {L}, 256], k2={k2}")
    say(f"[bf16] K1 at [1|2, 2, 32|48|1000, 128] (partly and fully padded "
        f"rows), batch mode's [B, 2, L, 128] and [10, 2, 1000|768|128, "
        f"128] with the row statistics; K2 at (B, L, k2) in {k2_shapes}; "
        f"K3 at [10, 2, 1000|768|128, 128]; each against its plain "
        f"version at bfloat16 on the card: largest error in ulps of "
        f"bfloat16 at the largest |plain value| (tolerance {BF16_ULPS}) "
        f"and absolute: "
        + "; ".join(f"{n} {u:.2f} ulp, {a:.3e}" for n, (u, a) in
                    found.items())
        + f"; two launches bitwise equal: {repeat}")
    for name, (ulps, _) in found.items():
        if not ulps <= BF16_ULPS:
            raise RuntimeError(f"{name}'s bfloat16 instance disagrees with "
                               "its plain version")
    if not all(repeat.values()):
        raise RuntimeError("a bfloat16 instance is not bitwise repeatable")
    return {name: tuple(v) for name, v in found.items()}


def inference_options(device, card, preprocess_config, model_config,
                      readme_wav, transformer, cuda_ffn, plain_attention):
    """The synthesize CLI's inference options on the card, each through its
    main (``drive_cli``): MelGAN and Griffin-Lim through model.yaml's
    vocoder.model, batch mode, --long, --torch_ckpt and the Mandarin
    frontend.  Raises on a failed gate.  -> {"launches": {path: {kernel:
    n}}, "timings": {...}, "errors": {...}}."""
    import copy

    import numpy as np
    import torch

    from fastspeech2_tpu_torch.configs.config import FastSpeech2Config
    from fastspeech2_tpu_torch.synthesis.vocoder import (
        GriffinLimVocoder,
        MelGANVocoder,
        get_vocoder,
        vocoder_infer,
    )
    from fastspeech2_tpu_torch.utils.params_io import (
        from_jax_params,
        load_variables_npz,
    )

    pp = preprocess_config["preprocessing"]
    hop, sr = pp["stft"]["hop_length"], pp["audio"]["sampling_rate"]
    bshapes = batch_shapes(preprocess_config)
    found, errors = {}, {}

    def check_launches(path, calls, launches, k4_per_vocoder, vocoders):
        """10 K1 + 10 K2 per acoustic forward (a re-dispatch is a second
        one), ``k4_per_vocoder`` K4 per vocoder forward, no K3 -> the
        acoustic forwards."""
        forwards = sum(
            2 if int(c["out"].duration_rounded.sum(dim=1).max())
            > model_config["max_seq_len"] else 1 for c in calls)
        expected = {"K1": 10 * forwards, "K2": 10 * forwards, "K3": 0,
                    "K4": k4_per_vocoder * vocoders, "K1_bf16": 0,
                    "K2_bf16": 0, "K3_bf16": 0}
        if launches != expected:
            raise RuntimeError(f"[{path}] launches {launches}, expected "
                               f"{expected}")
        found[path] = launches
        return forwards

    def check_wav(path, wav, out, i=0):
        mel_len = int(out.mel_len[i])
        peak = int(np.abs(wav.astype(np.int32)).max())
        if len(wav) != mel_len * hop or mel_len <= 0:
            raise RuntimeError(f"[{path}] wav length {len(wav)} is not "
                               f"mel_len {mel_len} x hop {hop}")
        if peak == 0:
            raise RuntimeError(f"[{path}] the wav is silent")
        if not torch.isfinite(out.postnet_mel).all():
            raise RuntimeError(f"[{path}] the mel is not finite")
        return mel_len, peak

    with tempfile.TemporaryDirectory() as tmp:
        def yaml_file(name, cfg):
            path = os.path.join(tmp, f"{name}.yaml")
            with open(path, "w") as f:
                yaml.safe_dump(cfg, f)
            return path

        def argv(text, model=f"{CONFIG}/model.yaml",
                 pre=f"{CONFIG}/preprocess.yaml",
                 weights=("--weights_npz", ACOUSTIC_NPZ),
                 vocoder_ckpt=VOCODER_NPZ):
            args = ["--mode", "single", "--text", text, "-p", pre,
                    "-m", model, "-t", f"{CONFIG}/train.yaml", *weights,
                    "--result_path", os.path.join(tmp, "result")]
            if vocoder_ckpt:
                args += ["--vocoder_ckpt", vocoder_ckpt]
            return args

        def with_vocoder(name):
            return dict(model_config, vocoder=dict(model_config["vocoder"],
                                                   model=name))

        # melgan: vocoder.model MelGAN on its tracked snapshot
        melgan_cfg = with_vocoder("MelGAN")
        (wavs, out, _), launches, calls, _, cli_s = drive_cli(argv(
            README_SENTENCE, model=yaml_file("model_melgan", melgan_cfg),
            vocoder_ckpt=MELGAN_NPZ))
        forwards = check_launches("melgan", calls, launches, 0, 1)
        mel_len, peak = check_wav("melgan", wavs[0], out)
        mel = out.postnet_mel
        melgan = get_vocoder(melgan_cfg, preprocess_config, MELGAN_NPZ,
                             device)
        with torch.inference_mode():
            melgan_wav = melgan(mel)
        if not (isinstance(melgan, MelGANVocoder)
                and torch.isfinite(melgan_wav).all()):
            raise RuntimeError("[melgan] the vocoder's wav is not finite")
        again = vocoder_infer(mel, melgan, preprocess_config,
                              lengths=out.mel_len.cpu().numpy())[0]
        say(f"[melgan] {README_SENTENCE!r} with vocoder.model MelGAN "
            f"({MELGAN_NPZ}): {len(wavs[0])} samples = mel_len {mel_len} x "
            f"hop {hop}; peak {peak}; finite; {forwards} acoustic "
            f"forward(s); launches {launches}; the same vocoder again gives "
            f"the CLI's wav: {np.array_equal(again, wavs[0])}; CLI main "
            f"{cli_s:.2f} s")
        if not np.array_equal(again, wavs[0]):
            raise RuntimeError("[melgan] the vocoder does not repeat the "
                               "CLI's wav")

        # griffin-lim: vocoder.model none; the card against the CPU from
        # the same initial phase (drawn on the CPU from seed 0)
        gl_cfg = with_vocoder("none")
        (wavs, out, _), launches, calls, _, cli_s = drive_cli(argv(
            README_SENTENCE, model=yaml_file("model_none", gl_cfg),
            vocoder_ckpt=None))
        forwards = check_launches("griffin-lim", calls, launches, 0, 1)
        mel_len, peak = check_wav("griffin-lim", wavs[0], out)
        gl = get_vocoder(gl_cfg, preprocess_config, None, device)
        gl_cpu = get_vocoder(gl_cfg, preprocess_config, None, "cpu")
        with torch.inference_mode():
            first = gl(out.postnet_mel)
            second = gl(out.postnet_mel)
            torch.cuda.synchronize()
            on_cpu = gl_cpu(out.postnet_mel.cpu())
        repeat = torch.equal(first, second)
        gl_err = (first.cpu() - on_cpu).abs().max().item()
        errors["griffin-lim"] = gl_err
        cli_again = np.array_equal(vocoder_infer(
            out.postnet_mel, gl, preprocess_config,
            lengths=out.mel_len.cpu().numpy())[0], wavs[0])
        say(f"[griffin-lim] {README_SENTENCE!r} with vocoder.model none "
            f"(Griffin-Lim, {gl.n_iters} iterations, n_fft {gl.n_fft}): "
            f"{len(wavs[0])} samples = mel_len {mel_len} x hop {hop}; peak "
            f"{peak}; {forwards} acoustic forward(s); launches {launches}; "
            f"card vs CPU from the same initial phase on the "
            f"{out.postnet_mel.shape[1]}-frame mel: max_abs_err="
            f"{gl_err:.3e} (tolerance {GL_ATOL:g} of full scale; largest "
            f"|sample| {on_cpu.abs().max().item():.3e}); two card runs "
            f"bitwise equal: {repeat}; the CLI's wav repeated: {cli_again}; "
            f"CLI main {cli_s:.2f} s")
        if not (isinstance(gl, GriffinLimVocoder)
                and torch.isfinite(first).all()):
            raise RuntimeError("[griffin-lim] the wav is not finite")
        if not gl_err <= GL_ATOL:
            raise RuntimeError("[griffin-lim] the card disagrees with the "
                               "CPU")
        if not (repeat and cli_again):
            raise RuntimeError("[griffin-lim] two runs on the card differ")

        # batch: the corpus's metadata, 8 rows per forward; each forward's
        # mel against the same forward with the plain K1/K2
        result = os.path.join(tmp, "batch")
        (wavs, outs, paths), launches, calls, lines, cli_s = drive_cli([
            "--mode", "batch", "--source", BATCH_SOURCE,
            "-p", f"{CONFIG}/preprocess.yaml", "-m", f"{CONFIG}/model.yaml",
            "-t", f"{CONFIG}/train.yaml", "--weights_npz", ACOUSTIC_NPZ,
            "--vocoder_ckpt", VOCODER_NPZ, "--result_path", result])
        forwards = check_launches("batch", calls, launches, 6, len(calls))
        shapes = [(c["out"].postnet_mel.shape[0],
                   c["out"].src_pad_mask.shape[1]) for c in calls]
        if shapes != [(B, enc) for B, enc, _ in bshapes]:
            raise RuntimeError(f"[batch] forwards at {shapes}, expected "
                               f"{bshapes}")
        batch_err = 0.0
        for c in calls:
            rows = len(c["args"][0])
            saved = transformer.fused_attention, transformer.fused_conv_ffn
            transformer.fused_attention = plain_attention
            transformer.fused_conv_ffn = cuda_ffn.plain_conv_ffn
            try:
                plain = c["synth"].infer_ids(*c["args"], **c["kwargs"])
            finally:
                transformer.fused_attention, transformer.fused_conv_ffn = \
                    saved
            kern = c["out"]
            if not torch.equal(kern.duration_rounded[:rows],
                               plain.duration_rounded[:rows]):
                raise RuntimeError("[batch] kernel and plain forwards "
                                   "predict other durations")
            err = (kern.postnet_mel[:rows]
                   - plain.postnet_mel[:rows]).abs().max().item()
            batch_err = max(batch_err, err)
            say(f"[batch] forward of {rows} rows padded to batch "
                f"{kern.postnet_mel.shape[0]}: encoder L "
                f"{kern.src_pad_mask.shape[1]}, decoder L "
                f"{kern.mel.shape[1]}; launches {c['launches']}; mel "
                f"(postnet) vs the plain K1/K2 max_abs_diff={err:.3e} "
                f"(tolerance {MEL_ATOL:g})")
        errors["batch"] = batch_err
        mel_lens = [int(m) for c in calls
                    for m in c["out"].mel_len[: len(c["args"][0])]]
        for path, wav, mel_len in zip(paths, wavs, mel_lens):
            if len(wav) != mel_len * hop:
                raise RuntimeError(f"[batch] {path}: {len(wav)} samples, "
                                   f"expected {mel_len * hop}")
        written = sorted(os.listdir(result))
        n_wav = sum(n.endswith(".wav") for n in written)
        n_png = sum(n.endswith(".png") for n in written)
        no_png = [ln for ln in lines
                  if ln.startswith("matplotlib is not installed")]
        n_rows = sum(rows for _, _, rows in bshapes)
        say(f"[batch] --mode batch --source {BATCH_SOURCE}: {len(wavs)} "
            f"rows, {len(calls)} forwards at (batch, encoder L) {shapes}, "
            f"{forwards} acoustic forward(s); launches {launches}; "
            f"{n_wav} wavs and {n_png} pngs written"
            f"{'; ' + ' | '.join(no_png) if no_png else ''}; CLI main "
            f"{cli_s:.2f} s")
        if not batch_err <= MEL_ATOL:
            raise RuntimeError("[batch] a mel disagrees with plain K1/K2")
        if not (len(wavs) == n_wav == n_rows
                and (n_png == n_rows or (n_png == 0 and no_png))):
            raise RuntimeError(f"[batch] wrote {written}")

        # long: three sentences as one batch, joined with 120 ms pauses
        ([joined], chunks, [path]), launches, calls, lines, cli_s = \
            drive_cli(argv(LONG_TEXT) + ["--long"])
        forwards = check_launches("long", calls, launches, 6, 1)
        out = calls[0]["out"]
        pause = int(sr * 120.0 / 1000.0)
        lengths = [int(m) * hop for m in out.mel_len[: len(chunks)]]
        expected = sum(lengths) + pause * (len(chunks) - 1)
        say(f"[long] --long on {len(chunks)} sentences (batch "
            f"{out.postnet_mel.shape[0]}): joined wav {len(joined)} samples"
            f" = chunks {lengths} + {len(chunks) - 1} pauses of {pause}; "
            f"{forwards} acoustic forward(s); launches {launches}; printed "
            f"{[ln for ln in lines if ln.startswith('Synthesized')]}; "
            f"written {os.path.basename(path)}: {os.path.exists(path)}; CLI "
            f"main {cli_s:.2f} s")
        if len(chunks) != 3 or len(joined) != expected:
            raise RuntimeError("[long] the joined wav's length is not the "
                               "chunks' plus the pauses")
        if not os.path.exists(path):
            raise RuntimeError(f"[long] {path} not written")

        # torch_ckpt: the tracked npz as a reference-format .pth.tar
        cfg = FastSpeech2Config.build(preprocess_config, model_config)
        ckpt = os.path.join(tmp, "acoustic.pth.tar")
        torch.save({"model": from_jax_params(
            load_variables_npz(ACOUSTIC_NPZ), cfg)}, ckpt)
        (wavs, out, _), launches, calls, _, cli_s = drive_cli(argv(
            README_SENTENCE, weights=("--torch_ckpt", ckpt)))
        forwards = check_launches("torch_ckpt", calls, launches, 6, 1)
        check_wav("torch_ckpt", wavs[0], out)
        same = np.array_equal(wavs[0], readme_wav)
        say(f"[torch_ckpt] {README_SENTENCE!r} through --torch_ckpt "
            f"({{'model': state_dict}} from {ACOUSTIC_NPZ}): "
            f"{len(wavs[0])} samples; {forwards} acoustic forward(s); "
            f"launches {launches}; bitwise equal to the --weights_npz "
            f"wav: {same}; CLI main {cli_s:.2f} s")
        if not same:
            raise RuntimeError("[torch_ckpt] the wav differs from the "
                               "--weights_npz run's")

        # mandarin: tone-numbered pinyin with a language: zh config
        zh = copy.deepcopy(preprocess_config)
        zh["preprocessing"]["text"] = {"text_cleaners": [], "language": "zh"}
        zh_yaml = yaml_file("preprocess_zh", zh)
        (wavs, out, _), launches, calls, lines, cli_s = drive_cli(argv(
            PINYIN_TEXT, pre=zh_yaml))
        forwards = check_launches("mandarin", calls, launches, 6, 1)
        mel_len, peak = check_wav("mandarin", wavs[0], out)
        ids = [int(i) for i in calls[0]["args"][0][0]]
        phones = [ln for ln in lines if ln.startswith("Phoneme Sequence")]
        saved = sys.modules.get("pypinyin")
        sys.modules["pypinyin"] = None      # hanzi without pypinyin
        try:
            drive_cli(argv(HANZI_TEXT, pre=zh_yaml))
            hanzi = "no error"
        except RuntimeError as e:
            hanzi = str(e)
        finally:
            if saved is None:
                del sys.modules["pypinyin"]
            else:
                sys.modules["pypinyin"] = saved
        say(f"[mandarin] {PINYIN_TEXT!r} with language zh: {phones}, phone "
            f"IDs {ids}; {len(wavs[0])} samples = mel_len {mel_len} x hop "
            f"{hop}, peak {peak}, mel finite; {forwards} acoustic "
            f"forward(s); launches {launches}; hanzi {HANZI_TEXT!r} without "
            f"pypinyin raises: {hanzi!r}; CLI main {cli_s:.2f} s")
        if not hanzi.startswith("pypinyin is unavailable"):
            raise RuntimeError("[mandarin] hanzi did not raise the "
                               "RuntimeError")

        # the two vocoders' forward on the README sentence's 1000-frame mel
        with torch.inference_mode():
            timings = {
                "melgan_ms": cuda_time_ms(lambda: melgan(mel)),
                "griffin_lim_ms": cuda_time_ms(lambda: gl(mel), iters=5,
                                               warmup=1)}
        say(f"[timing] vocoder forward on the {mel.shape[1]}-frame mel "
            f"(CUDA events): MelGAN {timings['melgan_ms']:.4f} ms (cuDNN "
            f"convolutions), Griffin-Lim {timings['griffin_lim_ms']:.4f} ms "
            f"({gl.n_iters} iterations, cuFFT); on {card}")
    return {"launches": found, "timings": timings, "errors": errors}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 1
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    from fastspeech2_tpu_torch.cli import synthesize_cli
    from fastspeech2_tpu_torch.configs.config import load_yaml_configs
    from fastspeech2_tpu_torch.models import transformer
    from fastspeech2_tpu_torch.models.hifigan import ResBlock
    from fastspeech2_tpu_torch.ops import (
        cuda_attention,
        cuda_build,
        cuda_ffn,
        cuda_resblock,
    )
    from fastspeech2_tpu_torch.ops.attention import (
        multi_head_attention,
        plain_attention_backward,
    )
    from fastspeech2_tpu_torch.synthesis.pipeline import Synthesizer
    from fastspeech2_tpu_torch.synthesis.vocoder import (
        get_vocoder,
        vocoder_infer,
    )
    from fastspeech2_tpu_torch.tools.kernel_bounds import (
        attention_bound_ms,
        ffn_bound_ms,
        parity_resblock_shapes,
        resblock_bound_ms,
    )
    from fastspeech2_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda")     # also pins TF32 off
    preprocess_config, model_config, _ = load_yaml_configs(
        f"{CONFIG}/preprocess.yaml", f"{CONFIG}/model.yaml",
        f"{CONFIG}/train.yaml")
    # batch mode's forwards: [(padded batch, encoder L, real rows)]
    bshapes = batch_shapes(preprocess_config)
    k2_shapes = K2_SHAPES + tuple(
        (B, L, 1) for B, enc, _ in bshapes for L in (enc, 1000))

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say(card)

    # 2. build
    t0 = time.perf_counter()
    cuda_build.load_library()
    info = cuda_build.build_info
    ptxas = [ln.strip() for ln in info.get("ptxas", "").splitlines()
             if "Used" in ln or "spill" in ln]
    say(f"[build] {'built' if info['built'] else 'loaded'} "
        f"{os.path.basename(info['path'])} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {info['seconds']:.2f} s); ptxas: {' | '.join(ptxas)}")
    lib = cuda_build.load_library()
    occupancy = {"mha_fwd_f32_kernel": lib.fs2_mha_fwd_blocks_per_sm(),
                 "mha_bwd_dkdv_kernel": lib.fs2_mha_bwd_blocks_per_sm(),
                 "mha_fwd_bf16_kernel": lib.fs2_mha_fwd_bf16_blocks_per_sm(),
                 "mha_bwd_dkdv_bf16_kernel":
                     lib.fs2_mha_bwd_bf16_blocks_per_sm()}
    per_kernel = ptxas_by_kernel(info.get("ptxas", ""),
                                 ATTENTION_KERNELS + CONV_KERNELS)
    for name, row in per_kernel.items():
        say(f"[build] {name}: {row['instances']} instance(s), at most "
            f"{row['max_registers']} registers, {row['spill_bytes']} bytes "
            f"of spill stores and loads in all; resident blocks per SM "
            f"{occupancy.get(name, 'not queried')}")
    if any(row["instances"] == 0 or row["spill_bytes"]
           for row in per_kernel.values()):
        raise RuntimeError(f"a kernel is missing from the build or spills: "
                           f"{per_kernel}")
    hmma = hmma_counts(info["path"], ATTENTION_KERNELS + CONV_KERNELS)
    say(f"[build] HMMA (tensor-core) instructions in the SASS (summed over "
        f"a template's instances): "
        f"{'not measured (no cuobjdump)' if hmma is None else hmma}")
    if hmma is not None and not all(hmma.get(n, 0) > 0
                                    for n in MMA_KERNELS):
        raise RuntimeError("a kernel that multiplies has no tensor-core "
                           "instruction")
    k1_grids = {(B, L): cuda_attention.forward_plan(B, 2, L)[0]
                for B, L in ((1, 32), (1, 1000), (TRAIN_BATCH, 128),
                             (TRAIN_BATCH, 768), (TRAIN_BATCH, 1000))}
    say(f"[build] K1's grid (query tiles, B*H, key chunks) at [B, 2, L, "
        f"128], by (B, L): {k1_grids}; {math.prod(k1_grids[(1, 1000)])} "
        f"blocks at [1, 2, 1000, 128] on "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    k2_plans = {(B, L): cuda_ffn.forward_plan(B, L, 1024, 9)
                for B, L, _ in k2_shapes}
    say(f"[build] K2's plan (positions per block and tap splits of the first "
        f"conv, hidden groups of the second) at [B, L, 256] -> 1024, by "
        f"(B, L): {k2_plans}")

    # 3. K1 vs plain: the encoder's L (32 for the README sentence's 31
    #    phones, 48 for 33-48 phones) and the decoder's (1000); each at
    #    [1, 2, L, 128] with a partly padded row, and as a batch of one full
    #    and one fully padded row
    k1_err = 0.0
    for L, partial in ((32, 31), (48, 33), (1000, 253)):
        for lens in ([partial], [L, 0]):
            q, k, v, mask = attention_inputs(lens, L, device, seed=L)
            got = cuda_attention.fused_attention(q, k, v, mask)
            torch.cuda.synchronize()
            ref = multi_head_attention(q, k, v, mask)
            if not torch.isfinite(got).all():
                raise RuntimeError(f"K1 output not finite at L={L}, "
                                   f"lens={lens}")
            k1_err = max(k1_err, (got - ref).abs().max().item())
    # ... at batch mode's shapes ([8|2, 2, L_enc|1000, 128]; one full, one
    #    fully padded and partly padded rows) ...
    k1_batch = [(B, L) for B, enc, _ in bshapes for L in (enc, 1000)]
    for B, L in k1_batch:
        q, k, v, mask, _ = attention_grad_inputs(L, device, seed=L + B, B=B)
        got = cuda_attention.fused_attention(q, k, v, mask)
        torch.cuda.synchronize()
        ref = multi_head_attention(q, k, v, mask)
        if not torch.isfinite(got).all():
            raise RuntimeError(f"K1 output not finite at [{B}, 2, {L}, 128]")
        k1_err = max(k1_err, (got - ref).abs().max().item())
    # ... and at the training slice's L, batch 10 (one full, one fully
    #    padded and partly padded rows), with the softmax statistics K3
    #    reads: the row max against the float32 masked scores' (absolute),
    #    the row sum relative to itself
    stats_rel = 0.0
    for L in (1000, 768, 128):
        q, k, v, mask, _ = attention_grad_inputs(L, device, seed=L + 3)
        got, row_max, row_sum = cuda_attention._launch_forward(
            q, k, v, mask, True)
        torch.cuda.synchronize()
        ref = multi_head_attention(q, k, v, mask)
        scores = (torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(128)
                  ).masked_fill(mask[:, None, None, :], -1e9)
        ref_max = scores.amax(dim=-1)
        ref_sum = torch.exp(scores - ref_max[..., None]).sum(dim=-1)
        del scores
        for name, t in (("output", got), ("row_max", row_max),
                        ("row_sum", row_sum)):
            if not torch.isfinite(t).all():
                raise RuntimeError(f"K1 {name} not finite at [10, 2, {L}, "
                                   "128]")
        k1_err = max(k1_err, (got - ref).abs().max().item(),
                     (row_max - ref_max).abs().max().item())
        stats_rel = max(stats_rel,
                        ((row_sum - ref_sum).abs() / ref_sum).max().item())
    say(f"[K1] attention kernel vs plain at [1|2, 2, 32|48|1000, 128], "
        f"batch mode's [B, 2, L, 128] for (B, L) in {k1_batch} and "
        f"[10, 2, 1000|768|128, 128], partly and fully padded rows: "
        f"max_abs_err={k1_err:.3e} over the output and the row max "
        f"(tolerance {KERNEL_ATOL:g}); row sum max relative error "
        f"{stats_rel:.3e} (tolerance {KERNEL_ATOL:g})")
    if not k1_err <= KERNEL_ATOL:
        raise RuntimeError("K1 disagrees with its plain version")
    if not stats_rel <= KERNEL_ATOL:
        raise RuntimeError("K1's row sums disagree with the plain scores'")

    # 4. K2 vs plain at every path shape, each launched twice
    k2_err = 0.0
    k2_repeat = True
    for B, L, k2 in k2_shapes:
        args = ffn_inputs(L, device, seed=L + k2 + B, k2=k2, B=B)
        got = cuda_ffn.fused_conv_ffn(*args)
        again = cuda_ffn.fused_conv_ffn(*args)
        torch.cuda.synchronize()
        ref = cuda_ffn.plain_conv_ffn(*args)
        if not torch.isfinite(got).all():
            raise RuntimeError(f"K2 output not finite at [{B}, {L}, 256]")
        k2_repeat = k2_repeat and torch.equal(got, again)
        k2_err = max(k2_err, (got - ref).abs().max().item())
    say(f"[K2] conv-FFN kernel vs plain at [B, L, 256] -> 1024, (B, L, k2) "
        f"in {k2_shapes}: max_abs_err={k2_err:.3e} (tolerance "
        f"{KERNEL_ATOL:g}); two launches bitwise equal: {k2_repeat}")
    if not k2_err <= KERNEL_ATOL:
        raise RuntimeError("K2 disagrees with its plain version")
    if not k2_repeat:
        raise RuntimeError("K2 is not bitwise repeatable")

    # 5. K3 vs plain at the training slice's L (decoder 1000, LJSpeech10's
    #    bucket 768, encoder 128), batch 10 with one full, one fully padded
    #    and partly padded rows
    k3_err = k3_rel = 0.0
    for L in (1000, 768, 128):
        q, k, v, mask, g = attention_grad_inputs(L, device, seed=L + 5)
        out, row_max, row_sum = cuda_attention._launch_forward(
            q, k, v, mask, True)
        got = cuda_attention.fused_attention_backward(
            q, k, v, mask, out, row_max, row_sum, g)
        torch.cuda.synchronize()
        ref = plain_attention_backward(q, k, v, mask, g)
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            if not torch.isfinite(a).all():
                raise RuntimeError(f"K3 {name} not finite at L={L}")
            err = (a - b).abs().max().item()
            k3_err = max(k3_err, err)
            k3_rel = max(k3_rel, err / b.abs().max().item())
    say(f"[K3] attention-backward kernel vs plain at [10, 2, 1000|768|128, "
        f"128], one full, one fully padded and partly padded rows: "
        f"max_abs_err={k3_err:.3e}, max relative to the largest |grad| "
        f"{k3_rel:.3e} (tolerance {K3_RTOL:g} relative)")
    if not k3_rel <= K3_RTOL:
        raise RuntimeError("K3 disagrees with its plain version")
    # the Function (K1 forward, K3 backward) vs autograd through the plain
    # forward; a fully padded batch row has P = 1/L, where the TPU kernel's
    # formula is held instead (autograd through the masked fill gives 0)
    q, k, v, mask, g = attention_grad_inputs(1000, device, seed=11)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(cuda_attention.fused_attention(*leaves, mask),
                              leaves, g.transpose(1, 2).contiguous()
                              .transpose(1, 2))
    plain_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(multi_head_attention(*plain_leaves, mask),
                              plain_leaves, g)
    formula = plain_attention_backward(q, k, v, mask, g)
    fn_rel = 0.0
    for a, b, c in zip(got, ref, formula):
        keyed = torch.cat([b[:1], b[2:]])   # row 1 is fully padded
        err = max((torch.cat([a[:1], a[2:]]) - keyed).abs().max().item(),
                  (a[1] - c[1]).abs().max().item())
        fn_rel = max(fn_rel, err / b.abs().max().item())
    say(f"[K3] autograd Function (K1 forward, K3 backward, strided incoming "
        f"gradient) vs torch.autograd.grad through the plain forward at "
        f"[10, 2, 1000, 128]: max relative to the largest |grad| "
        f"{fn_rel:.3e} (tolerance {K3_RTOL:g})")
    if not fn_rel <= K3_RTOL:
        raise RuntimeError("the attention Function's gradients disagree")
    # repeatability: K1 (on its single-launch and key-split grids) and K3
    # twice on the same inputs; no atomics, every sum in a fixed order
    repeat = {}
    for B, L in ((TRAIN_BATCH, 1000), (1, 1000)):
        if B == 1:
            q, k, v, mask = attention_inputs([253], L, device, seed=L + 13)
            g = torch.randn(q.shape, device=device)
        else:
            q, k, v, mask, g = attention_grad_inputs(L, device, seed=L + 13)
        fwd = [cuda_attention._launch_forward(q, k, v, mask, True)
               for _ in range(2)]
        bwd = [cuda_attention.fused_attention_backward(q, k, v, mask,
                                                       *fwd[0], g)
               for _ in range(2)]
        torch.cuda.synchronize()
        repeat[(B, L)] = (all(torch.equal(a, b) for a, b in zip(*fwd)),
                          all(torch.equal(a, b) for a, b in zip(*bwd)))
    say(f"[repeat] K1 and K3 launched twice on the same inputs at [10, 2, "
        f"1000, 128] and [1, 2, 1000, 128] (K1 on its key-split grid): "
        f"bitwise equal (K1, K3): {repeat}")
    if not all(all(v) for v in repeat.values()):
        raise RuntimeError("K1 or K3 is not bitwise repeatable")

    # the bfloat16 instances of K1, K2 and K3 against their plain versions
    bf16_errors = bf16_kernel_checks(device, bshapes, k2_shapes)

    # 6. K4 vs plain at the 12 ResBlock shapes of a 1000-frame parity
    #    forward, at L = 8 (a 1-frame mel at C = 256: the halo is wider than
    #    L) and at L ragged against every tile
    k4_shapes = parity_resblock_shapes(1000)
    k4_err = k4_rel = 0.0
    k4_repeat = True
    for C, L, k in k4_shapes + [(256, 8, 3), (256, 8, 7), (256, 8, 11),
                                (128, 1531, 11), (32, 777, 7)]:
        x, w1, b1, w2, b2 = resblock_inputs(C, L, k, device, seed=C + L + k)
        with torch.inference_mode():
            got = cuda_resblock.fused_resblock(x, w1, b1, w2, b2, DILATIONS)
            if (C, L, k) in k4_shapes:
                again = cuda_resblock.fused_resblock(x, w1, b1, w2, b2,
                                                     DILATIONS)
                k4_repeat = k4_repeat and torch.equal(got, again)
                del again
            torch.cuda.synchronize()
            ref = cuda_resblock.plain_resblock(x, w1, b1, w2, b2, DILATIONS)
        if not torch.isfinite(got).all():
            raise RuntimeError(f"K4 output not finite at C={C}, L={L}, k={k}")
        err = (got - ref).abs().max().item()
        k4_err = max(k4_err, err)
        k4_rel = max(k4_rel, err / ref.abs().max().item())
    del x, w1, b1, w2, b2, got, ref
    say(f"[K4] MRF ResBlock kernel vs plain at [1, C, L] = [1, 256, 8000], "
        f"[1, 128, 64000], [1, 64, 128000], [1, 32, 256000] with k = 3, 7, "
        f"11 each, [1, 256, 8] (k = 3, 7, 11), [1, 128, 1531] and "
        f"[1, 32, 777]: max_abs_err={k4_err:.3e}, max relative to the "
        f"largest |output| {k4_rel:.3e} (tolerance {K4_RTOL:g} relative); "
        f"two launches bitwise equal at the 12 path shapes: {k4_repeat}")
    if not k4_rel <= K4_RTOL:
        raise RuntimeError("K4 disagrees with its plain version")
    if not k4_repeat:
        raise RuntimeError("K4 is not bitwise repeatable")

    # 7. synthesis through the CLI's main; counts from this run only
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--mode", "single", "--text", README_SENTENCE,
                "--weights_npz", ACOUSTIC_NPZ, "--vocoder_ckpt", VOCODER_NPZ,
                "-p", f"{CONFIG}/preprocess.yaml",
                "-m", f"{CONFIG}/model.yaml", "-t", f"{CONFIG}/train.yaml",
                "--result_path", tmp]
        cuda_attention.launches = 0
        cuda_ffn.launches = 0
        cuda_resblock.launches = 0
        t0 = time.perf_counter()
        wavs, out, paths = synthesize_cli.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = {"K1": cuda_attention.launches, "K2": cuda_ffn.launches,
                    "K4": cuda_resblock.launches}
        with wave.open(paths[0], "rb") as f:
            written = f.readframes(f.getnframes())
    if written != wavs[0].astype("<i2").tobytes():
        raise RuntimeError("the written wav differs from the synthesized one")
    wav = wavs[0]
    hop = preprocess_config["preprocessing"]["stft"]["hop_length"]
    sr = preprocess_config["preprocessing"]["audio"]["sampling_rate"]
    mel_len = int(out.mel_len[0])
    need = int(out.duration_rounded.sum(dim=1).max())
    forwards = 2 if need > model_config["max_seq_len"] else 1
    peak = int(abs(wav.astype("int32")).max())
    say(f"[synthesis] {README_SENTENCE!r}: {len(wav)} samples = mel_len "
        f"{mel_len} x hop {hop}; peak {peak}; written wav read back equal; "
        f"{forwards} acoustic forward(s); launches K1={launches['K1']} "
        f"K2={launches['K2']} K4={launches['K4']} (HiFi-GAN-iSTFT, 6 K4 "
        f"per vocoder forward); CLI main "
        f"{cli_s:.2f} s (build, load, G2P and first calls included)")
    if len(wav) != mel_len * hop or mel_len <= 0:
        raise RuntimeError("wav length is not mel_len * hop")
    if peak < 100:
        raise RuntimeError("the wav is silent")
    if not torch.isfinite(out.postnet_mel).all():
        raise RuntimeError("the mel is not finite")
    for name in ("K1", "K2"):
        if launches[name] != 10 * forwards:
            raise RuntimeError(f"{name} launched {launches[name]} times, "
                               f"expected {10 * forwards} (10 per acoustic "
                               "forward)")
    if launches["K4"] != 6:
        raise RuntimeError(f"K4 launched {launches['K4']} times, expected 6 "
                           "(one iSTFT vocoder forward)")

    model, cfg = synthesize_cli.load_model_for_inference(
        preprocess_config, model_config, ACOUSTIC_NPZ, device)
    vocoder = get_vocoder(model_config, preprocess_config, VOCODER_NPZ,
                          device)
    synth = Synthesizer(model, cfg, preprocess_config, device,
                        vocoder=vocoder)
    ids, _ = synth.text_to_ids(README_SENTENCE)
    kern = synth.infer_ids([ids])
    # the same forward with the plain versions swapped in (comparison only)
    saved = transformer.fused_attention, transformer.fused_conv_ffn
    transformer.fused_attention = multi_head_attention
    transformer.fused_conv_ffn = cuda_ffn.plain_conv_ffn
    try:
        plain = synth.infer_ids([ids])
    finally:
        transformer.fused_attention, transformer.fused_conv_ffn = saved
    if not torch.equal(kern.duration_rounded, plain.duration_rounded):
        raise RuntimeError("kernel and plain forwards predict other durations")
    mel_err = (kern.postnet_mel - plain.postnet_mel).abs().max().item()
    say(f"[synthesis] mel (postnet) kernels vs plain versions on the card: "
        f"max_abs_diff={mel_err:.3e} (tolerance {MEL_ATOL:g}); durations "
        f"equal; encoder L={ids.shape[0]} phones padded to "
        f"{kern.src_pad_mask.shape[1]}, decoder L={kern.mel.shape[1]}")
    if not mel_err <= MEL_ATOL:
        raise RuntimeError("the kernel forward's mel disagrees with plain")
    # the iSTFT vocoder's wav with K4 against its plain ResBlocks
    istft_resblocks = [m for m in vocoder.modules() if isinstance(m, ResBlock)]
    with torch.inference_mode():
        i_wav = vocoder(kern.postnet_mel)
        for m in istft_resblocks:
            m.fused = False
        i_plain = vocoder(kern.postnet_mel)
        for m in istft_resblocks:
            m.fused = True
    if not torch.isfinite(i_wav).all():
        raise RuntimeError("the iSTFT wav is not finite")
    istft_err = (i_wav - i_plain).abs().max().item()
    say(f"[synthesis] iSTFT vocoder wav with K4 ({len(istft_resblocks)} "
        f"ResBlocks) vs the plain ResBlocks on the card, "
        f"[1, {kern.postnet_mel.shape[1]}] frames -> {i_wav.shape[1]} "
        f"samples: max_abs_diff={istft_err:.3e} (tolerance {WAV_ATOL:g}; "
        f"largest |sample| {i_plain.abs().max().item():.3e})")
    if not istft_err <= WAV_ATOL:
        raise RuntimeError("the iSTFT vocoder's K4 wav disagrees with plain")

    # 8. the parity HiFi-GAN through the CLI's main, from its seeded random
    #    init (no --vocoder_ckpt); counts from this run only
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--mode", "single", "--text", README_SENTENCE,
                "--weights_npz", ACOUSTIC_NPZ,
                "-p", f"{CONFIG}/preprocess.yaml", "-m", PARITY_MODEL,
                "-t", f"{CONFIG}/train.yaml", "--result_path", tmp]
        cuda_attention.launches = 0
        cuda_ffn.launches = 0
        cuda_resblock.launches = 0
        t0 = time.perf_counter()
        p_wavs, p_out, _ = synthesize_cli.main(argv)
        torch.cuda.synchronize()
        p_cli_s = time.perf_counter() - t0
        parity_launches = {"K1": cuda_attention.launches,
                           "K2": cuda_ffn.launches,
                           "K4": cuda_resblock.launches}
    parity_model_config = load_yaml_configs(
        f"{CONFIG}/preprocess.yaml", PARITY_MODEL, f"{CONFIG}/train.yaml")[1]
    p_mel_len = int(p_out.mel_len[0])
    p_need = int(p_out.duration_rounded.sum(dim=1).max())
    p_forwards = 2 if p_need > parity_model_config["max_seq_len"] else 1
    p_peak = int(abs(p_wavs[0].astype("int32")).max())
    say(f"[parity] {README_SENTENCE!r} with {PARITY_MODEL} (HiFi-GAN, "
        f"seeded random init): {len(p_wavs[0])} samples = mel_len "
        f"{p_mel_len} x hop {hop}; peak {p_peak}; {p_forwards} acoustic "
        f"forward(s); launches K1={parity_launches['K1']}"
        f" K2={parity_launches['K2']} K4={parity_launches['K4']}; CLI main "
        f"{p_cli_s:.2f} s")
    if len(p_wavs[0]) != p_mel_len * hop or p_mel_len <= 0:
        raise RuntimeError("parity wav length is not mel_len * hop")
    if (parity_launches["K1"], parity_launches["K2"]) != (10 * p_forwards,) * 2:
        raise RuntimeError(f"parity synthesis launched {parity_launches}, "
                           f"expected {10 * p_forwards} K1 and K2")
    if parity_launches["K4"] != 12:
        raise RuntimeError(f"K4 launched {parity_launches['K4']} times, "
                           "expected 12 (one vocoder forward)")
    # the same vocoder again (the seeded init), and the CLI's wav from it
    parity_vocoder = get_vocoder(parity_model_config, preprocess_config,
                                 None, device)
    resblocks = [m for m in parity_vocoder.modules()
                 if isinstance(m, ResBlock)]
    again = vocoder_infer(p_out.postnet_mel, parity_vocoder,
                          preprocess_config,
                          lengths=p_out.mel_len.cpu().numpy())[0]
    if not (again == p_wavs[0]).all():
        raise RuntimeError("the parity vocoder does not give the CLI's wav")
    with torch.inference_mode():
        p_wav = parity_vocoder(p_out.postnet_mel)
        for m in resblocks:
            m.fused = False
        p_plain = parity_vocoder(p_out.postnet_mel)
        for m in resblocks:
            m.fused = True
    if not torch.isfinite(p_wav).all():
        raise RuntimeError("the parity wav is not finite")
    wav_err = (p_wav - p_plain).abs().max().item()
    say(f"[parity] vocoder wav with K4 vs the plain ResBlocks on the card, "
        f"[1, {p_out.postnet_mel.shape[1]}] frames -> {p_wav.shape[1]} "
        f"samples, finite: max_abs_diff={wav_err:.3e} (tolerance "
        f"{WAV_ATOL:g}; largest |sample| {p_plain.abs().max().item():.3e})")
    if not wav_err <= WAV_ATOL:
        raise RuntimeError("the K4 vocoder's wav disagrees with plain")

    # the README sentence at --dtype bfloat16 through the CLI's main, the
    # counts set to 0 just before and read just after
    with tempfile.TemporaryDirectory() as tmp:
        (b_wavs, b_out, _), b_launches, b_calls, _, b_cli_s = drive_cli([
            "--mode", "single", "--text", README_SENTENCE,
            "--weights_npz", ACOUSTIC_NPZ, "--vocoder_ckpt", VOCODER_NPZ,
            "-p", f"{CONFIG}/preprocess.yaml", "-m", f"{CONFIG}/model.yaml",
            "-t", f"{CONFIG}/train.yaml", "--result_path", tmp,
            "--dtype", "bfloat16"])
    b_need = int(b_out.duration_rounded.sum(dim=1).max())
    b_forwards = 2 if b_need > model_config["max_seq_len"] else 1
    expected = {"K1": 0, "K2": 0, "K3": 0, "K4": 6,
                "K1_bf16": 10 * b_forwards, "K2_bf16": 10 * b_forwards,
                "K3_bf16": 0}
    b_mel_len = int(b_out.mel_len[0])
    b_synth = b_calls[0]["synth"]
    saved = transformer.fused_attention, transformer.fused_conv_ffn
    transformer.fused_attention = multi_head_attention
    transformer.fused_conv_ffn = cuda_ffn.plain_conv_ffn
    try:
        b_plain = b_synth.infer_ids(*b_calls[0]["args"],
                                    **b_calls[0]["kwargs"])
    finally:
        transformer.fused_attention, transformer.fused_conv_ffn = saved
    b_same_d = torch.equal(b_out.duration_rounded, b_plain.duration_rounded)
    # the pitch and energy embeddings bucketize the predictions: an ulp of
    # difference at a bin edge picks another embedding, and that phone's
    # frames then differ by O(1).  So the kernels are held on the same
    # forward teacher-forced on the CLI run's own durations and
    # predictions, which pins every bucket, with the kernels and with the
    # plain versions
    adaptor = b_synth.model.variance_adaptor
    flipped = {
        name: int((torch.searchsorted(bins, getattr(b_out, pred).float())
                   != torch.searchsorted(bins, getattr(b_plain, pred).float())
                   ).sum())
        for name, pred, bins in (
            ("pitch", "pitch_prediction", adaptor.pitch_bins),
            ("energy", "energy_prediction", adaptor.energy_bins))}
    b_spk, b_texts, b_src_lens = b_synth._pack_batch(*b_calls[0]["args"][:2])

    def pinned_forward():
        with torch.inference_mode():
            return b_synth.model(
                b_spk, b_texts, b_src_lens, mel_lens=b_out.mel_len,
                max_mel_len=b_out.mel.shape[1],
                p_targets=b_out.pitch_prediction.float(),
                e_targets=b_out.energy_prediction.float(),
                d_targets=b_out.duration_rounded)

    pinned = pinned_forward()
    transformer.fused_attention = multi_head_attention
    transformer.fused_conv_ffn = cuda_ffn.plain_conv_ffn
    try:
        pinned_plain = pinned_forward()
    finally:
        transformer.fused_attention, transformer.fused_conv_ffn = saved
    frames = min(b_mel_len, mel_len)
    diffs = {}
    for name in ("mel", "postnet_mel"):
        got, plain = getattr(pinned, name), getattr(pinned_plain, name)
        diffs[name] = dict(
            ulps=bf16_ulps(got[0, :b_mel_len], plain[0, :b_mel_len]),
            plain=(got.float() - plain.float()).abs().max().item(),
            cli=(getattr(b_out, name).float() - getattr(
                b_plain, name).float()).abs().max().item(),
            f32=(getattr(b_out, name)[0, :frames].float()
                 - getattr(kern, name)[0, :frames]).abs().max().item())
    b_mel_ulps = max(diffs["mel"]["ulps"], diffs["postnet_mel"]["ulps"])
    say(f"[bf16 synthesis] {README_SENTENCE!r} with --dtype bfloat16: "
        f"{len(b_wavs[0])} samples = mel_len {b_mel_len} x hop {hop} "
        f"(float32: {mel_len}); mel {b_out.postnet_mel.dtype}, finite: "
        f"{bool(torch.isfinite(b_out.postnet_mel.float()).all())}; "
        f"{b_forwards} acoustic forward(s); launches {b_launches}; CLI "
        f"main {b_cli_s:.2f} s; kernels vs plain versions at bfloat16 on "
        f"the card: the inference forwards' durations equal {b_same_d}, "
        f"phones whose pitch / energy bucket differs {flipped}, mel "
        f"max_abs_diff before / after the PostNet "
        f"{diffs['mel']['cli']:.3e} / {diffs['postnet_mel']['cli']:.3e}; "
        f"the forward teacher-forced on the CLI run's durations and "
        f"predictions: mel before the PostNet max_abs_diff="
        f"{diffs['mel']['plain']:.3e} ({diffs['mel']['ulps']:.2f} ulp of "
        f"bfloat16 at its largest |value| over the {b_mel_len} spoken "
        f"frames), after the PostNet {diffs['postnet_mel']['plain']:.3e} "
        f"({diffs['postnet_mel']['ulps']:.2f} ulp), tolerance "
        f"{BF16_MEL_ULPS} for both; largest difference of "
        f"the CLI's bfloat16 mel from the float32 run's over the first "
        f"{frames} frames: before the PostNet {diffs['mel']['f32']:.3e}, "
        f"after {diffs['postnet_mel']['f32']:.3e}")
    if b_launches != expected:
        raise RuntimeError(f"bfloat16 synthesis launched {b_launches}, "
                           f"expected {expected}")
    with torch.inference_mode():   # the vocoder's float wav, before int16
        b_wav_finite = bool(torch.isfinite(vocoder(
            b_out.postnet_mel.float())).all())
    if (len(b_wavs[0]) != b_mel_len * hop or b_mel_len <= 0
            or b_out.postnet_mel.dtype != torch.bfloat16
            or not torch.isfinite(b_out.postnet_mel.float()).all()
            or not b_wav_finite):
        raise RuntimeError("the bfloat16 synthesis's mel or wav is wrong")
    if not (b_same_d and b_mel_ulps <= BF16_MEL_ULPS):
        raise RuntimeError("the bfloat16 forward's mel disagrees with plain")

    # the inference options of the synthesize CLI, each through its main
    # with the counts set to 0 just before and read just after
    options = inference_options(device, card, preprocess_config,
                                model_config, wavs[0], transformer,
                                cuda_ffn, multi_head_attention)

    # 9. timings at the path's shapes
    import torch.nn.functional as F

    enc_len = kern.src_pad_mask.shape[1]
    timings = {}
    for L, partial in ((enc_len, ids.shape[0]), (1000, mel_len)):
        q, k, v, mask = attention_inputs([partial], L, device, seed=7)
        additive = torch.zeros(1, 1, 1, L, device=device).masked_fill(
            mask[:, None, None, :], -1e9)
        timings[("K1", 1, L)] = with_bound(dict(
            ms=cuda_time_ms(lambda: cuda_attention.fused_attention(
                q, k, v, mask)),
            plain_ms=cuda_time_ms(lambda: multi_head_attention(q, k, v, mask)),
            library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=additive))), attention_bound_ms(1, 2, L))
    # ... and at batch mode's batch-8 shapes (one full, one fully padded
    #    and partly padded rows)
    B8, enc8, _ = bshapes[0]
    for L in (enc8, 1000):
        q, k, v, mask, _ = attention_grad_inputs(L, device, seed=8, B=B8)
        additive = torch.zeros(B8, 1, 1, L, device=device).masked_fill(
            mask[:, None, None, :], -1e9)
        timings[("K1", B8, L)] = with_bound(dict(
            ms=cuda_time_ms(lambda: cuda_attention.fused_attention(
                q, k, v, mask)),
            plain_ms=cuda_time_ms(lambda: multi_head_attention(q, k, v, mask)),
            library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=additive))), attention_bound_ms(B8, 2, L))
    # K2 as the model calls it, its weight pack made once: the README
    # sentence's encoder and decoder, batch mode's batch-8 forward, the
    # validation forward at batch 10
    for B, L in ((1, enc_len), (1, 1000), (B8, enc8), (B8, 1000),
                 (TRAIN_BATCH, 128), (TRAIN_BATCH, 1000)):
        args = ffn_inputs(L, device, seed=9, B=B)
        packed = cuda_ffn.pack_ffn_weights(args[1], args[3])
        with torch.inference_mode():
            timings[("K2", B, L)] = with_bound(dict(
                ms=cuda_time_ms(lambda: cuda_ffn.fused_conv_ffn(
                    *args, packed=packed)),
                plain_ms=cuda_time_ms(lambda: cuda_ffn.plain_conv_ffn(*args)),
                library_ms=None), ffn_bound_ms(B, L))

    for (name, B, L), t in sorted(timings.items()):
        lib = ("null" if t["library_ms"] is None
               else f"{t['library_ms']:.4f} ms")
        say(f"[timing] {name} B={B} L={L}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, library {lib}, bound "
            f"{t['bound_ms']:.3e} ms ({t['bound_by']}; {t['bound_basis']}); "
            f"SIMT bound {t['simt_bound_ms']:.3e} ms on {card}")

    def host_ms(fn, n=5):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), min(times)

    e2e = host_ms(lambda: synth.synthesize([README_SENTENCE]))
    front = host_ms(lambda: synth.text_to_ids(README_SENTENCE))
    fwd = host_ms(lambda: synth.infer_ids([ids]))
    voc = host_ms(lambda: vocoder_infer(kern.postnet_mel, vocoder,
                                        preprocess_config,
                                        lengths=kern.mel_len.cpu().numpy()))
    b_fwd = host_ms(lambda: b_synth.infer_ids(*b_calls[0]["args"],
                                              **b_calls[0]["kwargs"]))
    say(f"[timing] text->wav end to end: median {e2e[0]:.2f} ms over 5 "
        f"(min {e2e[1]:.2f}) for {len(wav) / sr:.3f} s of audio; parts "
        f"(median ms): frontend with neural G2P {front[0]:.2f}, acoustic "
        f"forward {fwd[0]:.2f} (at bfloat16: {b_fwd[0]:.2f}, min "
        f"{b_fwd[1]:.2f}), vocoder on the {kern.mel.shape[1]}-frame "
        f"mel + int16 trim {voc[0]:.2f}; on {card}")

    # K4 at the 12 ResBlock shapes of a 1000-frame parity forward; the
    # library yardstick is cuDNN's six-conv chain (the plain version) with
    # cuDNN free to autotune its algorithms (benchmark mode)
    k4_timings = []
    for C, L, k in k4_shapes:
        rb = resblock_inputs(C, L, k, device, seed=C + k)
        packed = cuda_resblock.pack_resblock_weights(*rb[1:])
        with torch.inference_mode():
            t = dict(
                shape=[1, C, L], k=k,
                ms=cuda_time_ms(lambda: cuda_resblock.fused_resblock(
                    *rb, DILATIONS, packed=packed)),
                plain_ms=cuda_time_ms(lambda: cuda_resblock.plain_resblock(
                    *rb, DILATIONS)))
            with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                            deterministic=False,
                                            allow_tf32=False):
                t["library_ms"] = cuda_time_ms(
                    lambda: cuda_resblock.plain_resblock(*rb, DILATIONS))
        k4_timings.append(with_bound(t, resblock_bound_ms(1, L, C, k)))
        say(f"[timing] K4 [1, {C}, {L}] k={k}: kernel {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, cuDNN autotuned "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.3e} ms "
            f"({t['bound_by']}, 3xTF32); SIMT bound "
            f"{t['simt_bound_ms']:.3e} ms on {card}")
    del rb, packed
    k4_total = {key: sum(t[key] for t in k4_timings)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "simt_bound_ms")}
    voc_k4 = host_ms(lambda: vocoder_infer(p_out.postnet_mel, parity_vocoder,
                                           preprocess_config))
    for m in resblocks:
        m.fused = False
    voc_plain = host_ms(lambda: vocoder_infer(
        p_out.postnet_mel, parity_vocoder, preprocess_config))
    for m in resblocks:
        m.fused = True
    say(f"[timing] K4, the 12 calls of one 1000-frame parity forward: "
        f"kernel {k4_total['ms']:.4f} ms, plain {k4_total['plain_ms']:.4f} "
        f"ms, cuDNN autotuned {k4_total['library_ms']:.4f} ms, bound "
        f"{k4_total['bound_ms']:.4f} ms (3xTF32; SIMT "
        f"{k4_total['simt_bound_ms']:.4f} ms); the parity vocoder on the "
        f"{p_out.postnet_mel.shape[1]}-frame mel + int16: median "
        f"{voc_k4[0]:.2f} ms over 5 (min {voc_k4[1]:.2f}) with K4, "
        f"{voc_plain[0]:.2f} ms (min {voc_plain[1]:.2f}) with the plain "
        f"ResBlocks; on {card}")

    # K1 and K3 at the training shapes: the decoder's L = 1000, LJSpeech10's
    # bucket 768 and the encoder's 128, batch 10; the library yardstick for
    # K3 is the backward of SDPA with the same additive mask
    train_timings = {}
    for L in (1000, 768, 128):
        q, k, v, mask, g = attention_grad_inputs(L, device, seed=L)
        out, row_max, row_sum = cuda_attention._launch_forward(
            q, k, v, mask, True)
        additive = torch.zeros(TRAIN_BATCH, 1, 1, L, device=device
                               ).masked_fill(mask[:, None, None, :], -1e9)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves,
                                                  attn_mask=additive)
        train_timings[("K3", L)] = with_bound(dict(
            ms=cuda_time_ms(lambda: cuda_attention.fused_attention_backward(
                q, k, v, mask, out, row_max, row_sum, g)),
            plain_ms=cuda_time_ms(lambda: plain_attention_backward(
                q, k, v, mask, g)),
            library_ms=cuda_time_ms(lambda: torch.autograd.grad(
                sdpa_out, leaves, g, retain_graph=True))),
            attention_bound_ms(TRAIN_BATCH, 2, L, backward=True))
        train_timings[("K1", L)] = with_bound(dict(
            ms=cuda_time_ms(lambda: cuda_attention._launch_forward(
                q, k, v, mask, True)),
            plain_ms=cuda_time_ms(lambda: multi_head_attention(q, k, v,
                                                               mask)),
            library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=additive))),
            attention_bound_ms(TRAIN_BATCH, 2, L))
        del sdpa_out, leaves
    for (name, L), t in sorted(train_timings.items()):
        say(f"[timing] {name} at [10, 2, {L}, 128] (training): kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.3e} ms "
            f"({t['bound_by']}, 3xTF32); SIMT bound "
            f"{t['simt_bound_ms']:.3e} ms on {card}")

    # the bfloat16 instances at the same shapes, their plain versions at
    # bfloat16, and SDPA at bfloat16 with the same additive mask (its
    # backward for K3)
    bf = torch.bfloat16
    bf16_timings = {}
    for B, L, partial in ((1, enc_len, ids.shape[0]), (1, 1000, mel_len)):
        q, k, v, mask = attention_inputs([partial], L, device, seed=7)
        q, k, v = (t.to(bf) for t in (q, k, v))
        additive = torch.zeros(1, 1, 1, L, device=device).masked_fill(
            mask[:, None, None, :], -1e9).to(bf)
        bf16_timings[("K1", 1, L)] = with_bound(dict(
            ms=cuda_time_ms(lambda: cuda_attention.fused_attention(
                q, k, v, mask)),
            plain_ms=cuda_time_ms(lambda: multi_head_attention(q, k, v, mask)),
            library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=additive))),
            attention_bound_ms(1, 2, L, dtype="bfloat16"), BOUND_BASIS_BF16)
    for L in (1000, 768, 128):
        q, k, v, mask, g = attention_grad_inputs(L, device, seed=L)
        q, k, v, g = (t.to(bf) for t in (q, k, v, g))
        out, row_max, row_sum = cuda_attention._launch_forward(
            q, k, v, mask, True)
        additive = torch.zeros(TRAIN_BATCH, 1, 1, L, device=device
                               ).masked_fill(mask[:, None, None, :],
                                             -1e9).to(bf)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves,
                                                  attn_mask=additive)
        bf16_timings[("K3", TRAIN_BATCH, L)] = with_bound(dict(
            ms=cuda_time_ms(lambda: cuda_attention.fused_attention_backward(
                q, k, v, mask, out, row_max, row_sum, g)),
            plain_ms=cuda_time_ms(lambda: plain_attention_backward(
                q, k, v, mask, g)),
            library_ms=cuda_time_ms(lambda: torch.autograd.grad(
                sdpa_out, leaves, g, retain_graph=True))),
            attention_bound_ms(TRAIN_BATCH, 2, L, backward=True,
                               dtype="bfloat16"), BOUND_BASIS_K3_BF16)
        bf16_timings[("K1", TRAIN_BATCH, L)] = with_bound(dict(
            ms=cuda_time_ms(lambda: cuda_attention._launch_forward(
                q, k, v, mask, True)),
            plain_ms=cuda_time_ms(lambda: multi_head_attention(q, k, v,
                                                               mask)),
            library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=additive))),
            attention_bound_ms(TRAIN_BATCH, 2, L, dtype="bfloat16"),
            BOUND_BASIS_BF16)
        del sdpa_out, leaves
    for B, L in ((1, enc_len), (1, 1000), (TRAIN_BATCH, 128),
                 (TRAIN_BATCH, 1000)):
        args = ffn_inputs(L, device, seed=9, B=B)
        args = (args[0].to(bf),) + args[1:]
        packed = cuda_ffn.pack_ffn_weights(args[1], args[3], bf)
        with torch.inference_mode():
            bf16_timings[("K2", B, L)] = with_bound(dict(
                ms=cuda_time_ms(lambda: cuda_ffn.fused_conv_ffn(
                    *args, packed=packed)),
                plain_ms=cuda_time_ms(lambda: cuda_ffn.plain_conv_ffn(*args)),
                library_ms=None), ffn_bound_ms(B, L, dtype="bfloat16"),
                BOUND_BASIS_BF16)
    for (name, B, L), t in sorted(bf16_timings.items()):
        lib = ("null" if t["library_ms"] is None
               else f"{t['library_ms']:.4f} ms")
        say(f"[timing] {name} bfloat16 B={B} L={L}: kernel {t['ms']:.4f} "
            f"ms, plain {t['plain_ms']:.4f} ms, library (bfloat16) {lib}, "
            f"bound {t['bound_ms']:.3e} ms ({t['bound_by']}; "
            f"{t['bound_basis']}) on {card}")

    # 8. training at full width: 20 steps + one validation pass through the
    #    port's train(), counts set to 0 just before and read just after
    from fastspeech2_tpu_torch.data.synthetic import (
        generate_corpus,
        synthetic_preprocess_config,
    )
    from fastspeech2_tpu_torch.training.loop import train

    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus")
        # 30 utterances of 60-120 phones at 2-8 frames each: ~300-960
        # frames, LJSpeech's range; 10 held out for validation
        generate_corpus(corpus, n_utterances=30, min_phones=60,
                        max_phones=120, n_mels=80, seed=5, val_size=10)
        pre_cfg = synthetic_preprocess_config(corpus, n_mels=80)
        train_cfg = dict(load_yaml_configs(
            f"{CONFIG}/preprocess.yaml", f"{CONFIG}/model.yaml",
            f"{CONFIG}/train.yaml")[2])
        train_cfg["path"] = {k: os.path.join(tmp, k) for k in
                             ("ckpt_path", "log_path", "result_path")}
        # every utterance fits one bucket; the optimizer block unchanged
        train_cfg["bucket"] = {"text": 128, "mel": 1024}
        train_cfg["step"] = dict(train_cfg["step"], total_step=TRAIN_STEPS,
                                 log_step=1, val_step=TRAIN_STEPS,
                                 save_step=TRAIN_STEPS)
        step_times, counts, losses_seen = [], [], []
        lines = []

        def log(line):
            lines.append(line)
            say("[train] " + line)

        def hook(step, losses):
            torch.cuda.synchronize()
            step_times.append(time.perf_counter())
            counts.append((cuda_attention.launches,
                           cuda_attention.bwd_launches, cuda_ffn.launches,
                           cuda_resblock.launches))
            losses_seen.append([float(v) for v in losses])

        torch.cuda.reset_peak_memory_stats()
        # what earlier phases still hold; the step's own share is above it
        base_gib = torch.cuda.memory_allocated() / 2 ** 30
        zero_counts()
        t0 = time.perf_counter()
        _, _, final_step = train(pre_cfg, model_config, train_cfg, log=log,
                                 device=device, step_hook=hook)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_bf16 = {k: n for k, n in launch_counts().items()
                      if k.endswith("_bf16")}
        train_launches = {"K1": cuda_attention.launches,
                          "K3": cuda_attention.bwd_launches,
                          "K2": cuda_ffn.launches,
                          "K4": cuda_resblock.launches}
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        per_step = [tuple(b - a for a, b in zip((0, 0, 0, 0) if i == 0
                                                 else counts[i - 1], c))
                    for i, c in enumerate(counts)]
        eval_counts = tuple(t - c for t, c in zip(
            (train_launches["K1"], train_launches["K3"],
             train_launches["K2"], train_launches["K4"]), counts[-1]))
        # the first step pays cuDNN's and the allocator's first calls
        step_ms = [(b - a) * 1e3 for a, b in zip(step_times, step_times[1:])]
        median_step = statistics.median(step_ms)
        attn_ms = sum(n * (train_timings[("K1", L)]["ms"]
                           + train_timings[("K3", L)]["ms"])
                      for n, L in ((model_config["transformer"][
                          "encoder_layer"], 128), (model_config[
                              "transformer"]["decoder_layer"], 1000)))
        totals = [row[0] for row in losses_seen]
        first5 = statistics.mean(totals[:5])
        last5 = statistics.mean(totals[-5:])
        say(f"[train] {final_step} steps at batch {TRAIN_BATCH} (encoder L "
            f"128, decoder L 1000) in {train_s:.2f} s: median "
            f"{median_step:.2f} ms per step over steps 2-{final_step} (host "
            f"clock, device synchronised); peak memory {peak_gib:.2f} GiB, "
            f"{peak_gib - base_gib:.2f} above the {base_gib:.2f} held "
            f"before; "
            f"K1 + K3 at these shapes {attn_ms:.2f} ms = "
            f"{100 * attn_ms / median_step:.1f}% of a step; total loss "
            f"mean of the first 5 steps {first5:.4f}, of the last 5 "
            f"{last5:.4f}; launches per step (K1, K3, K2, K4) "
            f"{sorted(set(per_step))}, per eval forward {eval_counts}, "
            f"bfloat16 instances {train_bf16}; on {card}")
        if final_step != TRAIN_STEPS or len(losses_seen) != TRAIN_STEPS:
            raise RuntimeError(f"trained {final_step} steps, expected "
                               f"{TRAIN_STEPS}")
        if not all(math.isfinite(v) for row in losses_seen for v in row):
            raise RuntimeError("a training loss is not finite")
        if not last5 < first5:
            raise RuntimeError("the training loss did not fall")
        if set(per_step) != {(10, 10, 0, 0)}:
            raise RuntimeError(f"launches per train step {set(per_step)}, "
                               "expected 10 K1 + 10 K3 + 0 K2 + 0 K4")
        if eval_counts != (10, 0, 10, 0):
            raise RuntimeError(f"launches in the validation pass "
                               f"{eval_counts}, expected 10 K1 + 10 K2")
        if any(train_bf16.values()):
            raise RuntimeError(f"the float32 training launched bfloat16 "
                               f"kernels: {train_bf16}")
        if not any(ln.startswith(f"Validation Step {TRAIN_STEPS}")
                   for ln in lines):
            raise RuntimeError("no validation line")
        ckpt = os.path.join(train_cfg["path"]["ckpt_path"],
                            f"{TRAIN_STEPS}.pth.tar")
        if not os.path.exists(ckpt):
            raise RuntimeError(f"no checkpoint at {ckpt}")

        # resume through the CLI in a subprocess, two more steps
        resume_cfg = dict(train_cfg, step=dict(train_cfg["step"],
                                               total_step=TRAIN_STEPS + 2))
        paths = []
        for name, cfg in (("preprocess", pre_cfg),
                          ("model", model_config), ("train", resume_cfg)):
            path = os.path.join(tmp, f"{name}.yaml")
            with open(path, "w") as f:
                yaml.safe_dump(cfg, f)
            paths += [f"-{name[0]}", path]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "fastspeech2_tpu_torch.cli.train_cli",
             *paths, "--restore_step", "-1", "--dtype", "float32"],
            capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"train CLI failed:\n{proc.stdout}\n"
                               f"{proc.stderr}")
        out_lines = proc.stdout.splitlines()
        resumed = f"Resuming from step {TRAIN_STEPS}" in out_lines
        stepped = any(ln.startswith(f"Step {TRAIN_STEPS + 2}/") for ln in
                      out_lines)
        saved = os.path.exists(os.path.join(
            train_cfg["path"]["ckpt_path"], f"{TRAIN_STEPS + 2}.pth.tar"))
        say(f"[train] python -m fastspeech2_tpu_torch.cli.train_cli "
            f"--restore_step -1 --dtype float32: resumed at step "
            f"{TRAIN_STEPS}: {resumed}; "
            f"step {TRAIN_STEPS + 2} logged: {stepped}; its checkpoint "
            f"written: {saved}; {cli_s:.2f} s")
        if not (resumed and stepped and saved):
            raise RuntimeError(f"the CLI resume failed:\n{proc.stdout}")

        # 11. synthesis from the trained checkpoint
        wavs, out, wav_paths = synthesize_cli.main(
            ["--mode", "single", "--text", README_SENTENCE, *paths,
             "--restore_step", str(TRAIN_STEPS + 2),
             "--vocoder_ckpt", VOCODER_NPZ, "--result_path",
             os.path.join(tmp, "result")])
        torch.cuda.synchronize()
        trained_len = int(out.mel_len[0])
        finite = bool(torch.isfinite(out.postnet_mel).all())
        say(f"[synthesis] from the port's checkpoint of step "
            f"{TRAIN_STEPS + 2} (--restore_step): {len(wavs[0])} samples = "
            f"mel_len {trained_len} x hop {hop}; mel finite: {finite}; "
            f"written to {os.path.basename(wav_paths[0])} (after "
            f"{TRAIN_STEPS + 2} steps it is not speech)")
        if len(wavs[0]) != trained_len * hop or not finite:
            raise RuntimeError("synthesis from the trained checkpoint failed")

        # 12. reproducibility: REPRO_STEPS steps twice from one seed through
        #     train(), with no duty but the final checkpoint
        def trained_params(run, dtype=torch.float32):
            cfg = dict(train_cfg, path={
                k: os.path.join(tmp, f"repro{run}", k) for k in
                ("ckpt_path", "log_path", "result_path")})
            cfg["step"] = dict(cfg["step"], total_step=REPRO_STEPS,
                               log_step=REPRO_STEPS, val_step=10 ** 9,
                               save_step=10 ** 9)
            model, _, step = train(pre_cfg, model_config, cfg, dtype=dtype,
                                   log=lambda line: None, device=device)
            if step != REPRO_STEPS:
                raise RuntimeError(f"the repro run stopped at step {step}")
            return {n: p.detach().clone()
                    for n, p in model.named_parameters()}

        first, second = trained_params(0), trained_params(1)
        diffs = {n: (first[n] - second[n]).abs().max().item() for n in first}
        repro_diff = max(diffs.values())
        say(f"[repro] {REPRO_STEPS} training steps twice from one seed "
            f"through train(): max |parameter difference| {repro_diff:.3e} "
            f"({sum(v > 0 for v in diffs.values())} of {len(diffs)} "
            f"tensors differ)")
        if repro_diff != 0.0:
            raise RuntimeError("two trainings from one seed differ")

        # the train CLI at its default dtype, bfloat16: TRAIN_STEPS steps
        # through its main in this process; each step's launches and its
        # end (device synchronised) recorded around training.loop's
        # train_step, the counts set to 0 just before main
        from fastspeech2_tpu_torch.cli import train_cli
        from fastspeech2_tpu_torch.training import loop as train_loop

        bf_paths = []
        bf_train = dict(train_cfg, path={
            k: os.path.join(tmp, "bf16", k) for k in
            ("ckpt_path", "log_path", "result_path")})
        for name, cfg in (("preprocess", pre_cfg), ("model", model_config),
                          ("train", bf_train)):
            path = os.path.join(tmp, f"bf16_{name}.yaml")
            with open(path, "w") as f:
                yaml.safe_dump(cfg, f)
            bf_paths += [f"-{name[0]}", path]
        bf_steps = []
        inner_step = train_loop.train_step

        def recorded_step(model, optimizer, batch, step, grad_acc_step=1):
            before = launch_counts()
            losses = inner_step(model, optimizer, batch, step, grad_acc_step)
            torch.cuda.synchronize()
            after = launch_counts()
            bf_steps.append(dict(
                end=time.perf_counter(), dtype=model.dtype,
                launches={k: after[k] - before[k] for k in after},
                losses=[float(v) for v in losses]))
            return losses

        printed = io.StringIO()
        train_loop.train_step = recorded_step
        del first, second
        torch.cuda.reset_peak_memory_stats()
        bf_base_gib = torch.cuda.memory_allocated() / 2 ** 30
        zero_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(printed):
                _, _, bf_final = train_cli.main(bf_paths)
        finally:
            train_loop.train_step = inner_step
        torch.cuda.synchronize()
        bf_train_s = time.perf_counter() - t0
        bf_totals = launch_counts()
        bf_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        bf_lines = printed.getvalue().splitlines()
        bf_per_step = {tuple(sorted(r["launches"].items()))
                       for r in bf_steps}
        bf_eval = {k: bf_totals[k] - sum(r["launches"][k] for r in bf_steps)
                   for k in bf_totals}
        bf_step_ms = [(b["end"] - a["end"]) * 1e3
                      for a, b in zip(bf_steps, bf_steps[1:])]
        bf_median = statistics.median(bf_step_ms)
        bf_totals_loss = [r["losses"][0] for r in bf_steps]
        bf_first5 = statistics.mean(bf_totals_loss[:5])
        bf_last5 = statistics.mean(bf_totals_loss[-5:])
        say(f"[train bf16] python -m fastspeech2_tpu_torch.cli.train_cli at "
            f"its default dtype: {bf_final} steps at batch {TRAIN_BATCH} in "
            f"{bf_train_s:.2f} s, compute dtype {bf_steps[0]['dtype']}: "
            f"median {bf_median:.2f} ms per step over steps 2-{bf_final} "
            f"(host clock, device synchronised; float32 above: "
            f"{median_step:.2f} ms); peak memory {bf_peak_gib:.2f} GiB, "
            f"{bf_peak_gib - bf_base_gib:.2f} above the {bf_base_gib:.2f} "
            f"held before (float32: {peak_gib - base_gib:.2f} above "
            f"{base_gib:.2f}); total loss mean of the first 5 "
            f"steps {bf_first5:.4f}, of the last 5 {bf_last5:.4f}; launches "
            f"per step {[dict(t) for t in bf_per_step]}; in the validation "
            f"pass {bf_eval}; last line {bf_lines[-1]!r}; on {card}")
        if bf_final != TRAIN_STEPS or len(bf_steps) != TRAIN_STEPS:
            raise RuntimeError(f"the bfloat16 CLI trained {bf_final} steps, "
                               f"expected {TRAIN_STEPS}")
        if bf_steps[0]["dtype"] != torch.bfloat16:
            raise RuntimeError("the train CLI's default is not bfloat16")
        if not all(math.isfinite(v) for r in bf_steps for v in r["losses"]):
            raise RuntimeError("a bfloat16 training loss is not finite")
        if not bf_last5 < bf_first5:
            raise RuntimeError("the bfloat16 training loss did not fall")
        want = {k: 0 for k in bf_totals}
        if bf_per_step != {tuple(sorted(dict(want, K1_bf16=10,
                                             K3_bf16=10).items()))}:
            raise RuntimeError(f"launches per bfloat16 train step "
                               f"{bf_per_step}, expected 10 bfloat16 K1 + "
                               "10 bfloat16 K3 and nothing else")
        if bf_eval != dict(want, K1_bf16=10, K2_bf16=10):
            raise RuntimeError(f"launches in the bfloat16 validation pass "
                               f"{bf_eval}, expected 10 bfloat16 K1 + 10 "
                               "bfloat16 K2")

        # ... and REPRO_STEPS steps twice from one seed at bfloat16
        first, second = (trained_params(run, torch.bfloat16)
                         for run in (2, 3))
        diffs = {n: (first[n] - second[n]).abs().max().item() for n in first}
        bf_repro_diff = max(diffs.values())
        say(f"[repro bf16] {REPRO_STEPS} training steps twice from one seed "
            f"at bfloat16 through train(): max |parameter difference| "
            f"{bf_repro_diff:.3e} ({sum(v > 0 for v in diffs.values())} of "
            f"{len(diffs)} tensors differ)")
        if bf_repro_diff != 0.0:
            raise RuntimeError("two bfloat16 trainings from one seed differ")

    # 13. kernels line
    sources = {"K1": ("fused_attention", "fastspeech2_tpu_torch/csrc/attention.cu",
                      "fastspeech2_tpu/ops/pallas_attention.py:93",
                      "[1, 2, 1000, 128] f32"),
               "K2": ("fused_conv_ffn", "fastspeech2_tpu_torch/csrc/conv_ffn.cu",
                      "fastspeech2_tpu/ops/pallas_ffn.py:61",
                      "[1, 1000, 256] -> 1024, k=(9, 1) f32"),
               "K3": ("fused_attention_backward",
                      "fastspeech2_tpu_torch/csrc/attention_bwd.cu",
                      "fastspeech2_tpu/ops/pallas_attention.py:138",
                      "[10, 2, 1000, 128] f32")}
    errs = {"K1": k1_err, "K2": k2_err, "K3": k3_err}
    # K1, K2 and K3 at every shape the paths give them
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "simt_bound_ms")
    per_shape = {name: [
        dict(shape=[B, 2, L, 128], **{key: t[key] for key in keys})
        for (B, L), t in sorted(
            [((B, L), t) for (n, B, L), t in timings.items() if n == name]
            + [((TRAIN_BATCH, L), t) for (n, L), t in train_timings.items()
               if n == name])]
        for name in ("K1", "K3")}
    per_shape["K2"] = [dict(shape=[B, L, 256], **{key: t[key] for key in keys})
                       for (n, B, L), t in sorted(timings.items())
                       if n == "K2"]
    kernels = []
    for name in ("K1", "K2", "K3"):
        fn, src, replaces, shape = sources[name]
        t = (train_timings[(name, 1000)] if name == "K3"
             else timings[(name, 1, 1000)])
        # launches: K1 and K2 on the synthesis path (one acoustic forward),
        # K3 on the training path (20 steps)
        n = train_launches[name] if name == "K3" else launches[name]
        kernels.append({
            "name": f"{name} {fn}", "route": "cuda", "source": src,
            "replaces": replaces, "launches": n, "dtype": "float32",
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "bound_basis": t["bound_basis"],
            "simt_bound_ms": t.get("simt_bound_ms"), "shape": shape,
            "per_shape": per_shape.get(name),
            "launches_by_path": {"synthesis": launches.get(name, 0),
                                 "parity synthesis": parity_launches.get(
                                     name, 0),
                                 **{path: n[name] for path, n in
                                    options["launches"].items()},
                                 "training": train_launches[name]}})
    # K4: the sums over the 12 calls of one 1000-frame parity forward
    kernels.append({
        "name": "K4 fused_resblock", "route": "cuda",
        "source": "fastspeech2_tpu_torch/csrc/resblock.cu",
        "replaces": "fastspeech2_tpu/ops/pallas_resblock.py:122",
        "launches": parity_launches["K4"], "max_abs_err": k4_err,
        "dtype": "float32",
        "ms": k4_total["ms"], "plain_ms": k4_total["plain_ms"],
        "bound_ms": k4_total["bound_ms"],
        "bound_by": "/".join(sorted({t["bound_by"] for t in k4_timings})),
        "library_ms": k4_total["library_ms"], "bound_basis": BOUND_BASIS,
        "simt_bound_ms": k4_total["simt_bound_ms"],
        "sources": ["fastspeech2_tpu_torch/csrc/resblock.cu",
                    "fastspeech2_tpu_torch/csrc/resblock_conv.cu"],
        "shape": "the 12 ResBlock calls of a 1000-frame parity forward, "
                 "[1, 256|128|64|32, 8000|64000|128000|256000], k = 3, 7, "
                 "11, f32",
        "per_call": k4_timings,
        "launches_by_path": {"synthesis": launches["K4"],
                             "parity synthesis": parity_launches["K4"],
                             **{path: n["K4"] for path, n in
                                options["launches"].items()},
                             "training": train_launches["K4"]}})
    # the bfloat16 instances: launches on the bfloat16 synthesis path (K1
    # and K2, one acoustic forward) and the bfloat16 training path (K3,
    # TRAIN_STEPS steps)
    bf_launches = {"K1": b_launches["K1_bf16"], "K2": b_launches["K2_bf16"],
                   "K3": sum(r["launches"]["K3_bf16"] for r in bf_steps)}
    for name in ("K1", "K2", "K3"):
        fn, src, replaces, shape = sources[name]
        t = bf16_timings[(name, TRAIN_BATCH, 1000) if name == "K3"
                         else (name, 1, 1000)]
        per = [dict(shape=[B, 2, L, 128] if name != "K2" else [B, L, 256],
                    **{key: v[key] for key in keys})
               for (n, B, L), v in sorted(bf16_timings.items()) if n == name]
        kernels.append({
            "name": f"{name} {fn} bfloat16", "route": "cuda", "source": src,
            "replaces": replaces, "launches": bf_launches[name],
            "dtype": "bfloat16", "max_abs_err": bf16_errors[name][1],
            "max_err_bf16_ulps": bf16_errors[name][0], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "bound_basis": t["bound_basis"],
            "simt_bound_ms": t.get("simt_bound_ms"),
            "shape": shape.replace("f32", "bf16"), "per_shape": per,
            "launches_by_path": {
                "bf16 synthesis": b_launches[f"{name}_bf16"],
                "bf16 training": bf_totals[f"{name}_bf16"]}})
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
