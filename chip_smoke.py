#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fastspeech2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing flushed lines (a failing phase raises, and the run
exits non-zero; a run still going after HANG_S = 1,100 s prints every
thread's stack and exits non-zero; the whole run should end within
RUN_CEILING_S = 800 s, which its last lines report):

1. card      the GPU's name and power limit, as nvidia-smi prints them;
2. build     nvcc builds the port's CUDA kernels from csrc/ (seconds,
             the sources in parallel); every kernel's registers and spills
             over all its template instances (a spill fails the run), K1's
             and K3's resident blocks per SM, every kernel's tensor-core
             instructions in the SASS (HMMA, the mma.sync kind, and HGMMA,
             wgmma's: every kernel that multiplies must hold HGMMA and no
             HMMA), each K4 instance's and each float32 K1, K2 and K3 and
             bfloat16 K2 instance's registers, spills, shared memory and
             HGMMA and HMMA counts, K1's grid at float32 and bfloat16, K3's
             scratch at both dtypes (D alone: linear in L), the K1
             wrapper's host microseconds per call at the small shapes
             beside the kernel's own time, and K2's plan at both dtypes;
3. K1        the attention kernel against its plain version at the path's
             shapes, with partly and fully padded key rows;
4. K2        the conv-FFN kernel against its plain version at every path
             shape, each launched twice (bitwise equal);
5. K3        the attention-backward kernel against its plain version at the
             training shapes, at [2, 2, 2000, 128] and at one head a rank
             ([10, 1, 128|1000, 128]), each launched twice (bitwise equal),
             and the autograd Function (K1 forward, K3 backward) against
             autograd through the plain forward; K1 and K3 launched twice
             on the same inputs must agree bit for bit; K3's score
             contract: the raw scores through K1's routine, K3a's (Q's
             small parts from registers) and K3b's (K as A) bitwise equal
             at [10, 2, 1000, 128] and [2, 2, 2000, 128];
6. K4        the MRF ResBlock kernel against its plain version at the 12
             ResBlock shapes of a 1000-frame parity-vocoder forward (each
             launched twice, bitwise equal), at L = 8 (a 1-frame mel at
             C = 256) and at ragged L;
7. synthesis the README sentence, text -> wav, through the CLI's main with
             the tracked weights (HiFi-GAN-iSTFT); the kernels' launch
             counts over that run (6 K4 per iSTFT forward); the mel against
             the same forward with the plain versions, the iSTFT wav
             against the same vocoder with its plain ResBlocks; the
             sentence's float32 forward against the JAX package's on the
             CPU (the committed reference_data/readme_sentence_jax.npz):
             IDs, durations and bucket ids exactly, the mel to
             README_MEL_ATOL;
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
   long      --long on three sentences, one eager fused text->wav
             dispatch (a one-shot call makes no CUDA graph): the joined
             wav is the chunks plus the pauses;
   torch_ckpt  --torch_ckpt on the tracked weights as a reference-format
             .pth.tar: the wav bitwise equal to the --weights_npz run's;
   mandarin  tone-numbered pinyin with a language: zh config, and hanzi
             without pypinyin raising;
9. timings   each kernel, its plain version and the library yardstick
             (CUDA events; K1 and K2 also at batch mode's batch-8 shapes,
             K2 at every shape of K2_SHAPES; K1 beside SDPA and K2 beside
             its bound also by device time: CUDA events around calls
             queued behind a sleeping kernel, and torch.profiler's),
             text -> wav end to end, the parity vocoder's forward, and
             MelGAN's and Griffin-Lim's forward on the 1000-frame mel;
10. training 20 steps at full model width (config/LJSpeech10, batch 10) on
             a synthetic corpus through the port's train(), with one
             validation pass (its losses' forward and one sample's figure);
             K1 and K3 timed at the training shapes, K3 and SDPA's backward
             also by device time;
             launch counts per step and in the validation pass; the
             first input at each kernel, dtype and shape held against the
             plain version (so in the bfloat16 training below);
             then a resume from the checkpoint through the train CLI;
             after phase 12, scan mode (train.yaml's step block,
             scan_step 500, cut to SCAN_STEPS steps, K = SCAN_K; mel
             bucket SCAN_MEL_BUCKET: two shape groups) through the train
             CLI at bfloat16, each step a replay of its group's CUDA
             graph but each group's first: the "scan mode:" line, the
             stacks' bytes and the graphs line (2 graphs, capture s,
             pool bytes, peak memory), 10 bfloat16 K1 + K3 a step
             (captured launches x replays), the run bit for bit equal to
             train_step fed its schedule from the host and to a second
             scan run; a float32 scan run of SCAN_F32_STEPS steps bit for
             bit its eager replay; host ms a step of the graphed scan,
             the eager replay and the per-step path, the busy share
             (budget SCAN_BUDGET_S);
11. synthesis from the trained checkpoint through the synthesize CLI's
             --restore_step;
12. repro    5 training steps twice from one seed through train() on
             the per-step path (scan_step 1): every parameter must agree
             exactly;
13. prep     data preparation from the tracked clips: the align CLI's
             align_corpus on the card (loglik and time of each EM
             iteration; durations partition every clip; boundaries near
             the tracked TextGrids' reported), the preprocess CLI on the
             card from the tracked TextGrids (stats.json against the
             tracked one; mel, energy and DIO's voicing against the CPU),
             PREP_STEPS steps through the train CLI at its default dtype
             on those features with the synth_step duty (10 bfloat16 K1 +
             K2 and 12 K4 each, wavs mel_len*hop long) and --profile_dir
             (the trace names K1 and K3), and evaluate --synth on the last
             checkpoint; each EM stage's and Preprocessor stage's time and
             kernels from a second run in a torch.profiler window; the
             first input at each kernel, dtype and shape of the training,
             its duties and evaluate --synth launched again and held
             against the plain version;
14. kernels  one JSON line describing K1, K2, K3 and K4 and the bfloat16
             instances of K1, K2 and K3, with their launches on every
             driven path, phases 15-17 included (on the serving path: the
             graphs' replays times the launches each captured);
15. vocoder  vocoder training at full width on phase 13's features (run
             before phase 14's line): export_mels through its CLI (10 K1 +
             10 K2 per forward, each forward's mel against the plain
             versions to MEL_ATOL, 10 files of [mel_len, 80]; again at
             bfloat16, bfloat16 instances only); VOC_STEPS GAN steps
             through the train_vocoder CLI on the documented recipe
             (config_istft.json, --init_gen_npz, --mel_source mixed,
             --mel_weight 135, batch 16 x 8192, the default MPD and MSD):
             finite losses, no kernel launch in a GAN step, the step's
             median time and the peak memory; a resume for
             VOC_RESUME_STEPS steps in a torch.profiler window (kernel time
             by group, the device's busy share); the parity, MelGAN,
             gt_wav-with-augmentation and scan modes briefly; two
             trainings from one seed bitwise equal; the README sentence
             through the synthesize CLI on the trained checkpoint (6 K4,
             the wav against the plain ResBlocks to WAV_ATOL), its lean
             export (the same wav bit for bit), and phase 13's acoustic
             checkpoint through export_cli and --torch_ckpt (the
             --restore_step wav bit for bit);
16. serve    the serve CLI's build_server on the tracked weights (max
             batch 16) and warmup(grid="top"): one CUDA graph of the fused
             text->wav dispatch at batch 16 x text 128 (10 K1 + 10 K2 +
             6 K4 captured; its capture time and the graphs' pool); the
             caches of the constants it reads cleared and their memory
             handed out again; on a
             [16 x 128] batch of the corpus rows and the README sentence
             the replay against the eager dispatch (bit for bit) and the
             plain versions (WAV_ATOL), and K1's, K2's and K4's kernels
             inside a replay by torch.profiler; HTTP: requests one at a
             time (latency; each wav the solo dispatch's bit for bit), a
             burst of 32 concurrent requests with a /synthesize_stream and
             a long text beside it (coalesced; each wav the solo one's
             outside the batch-mates' tail), a second burst under the
             profiler (the device's idle share), 401, 413 and 429; then
             grid="background" while a burst is in flight (20 graphs;
             each wav within WAV_ATOL of its solo wav outside the tail)
             and grid="full" on top; one dispatch timed as a replay and
             eagerly; K1, K2 and K4 at the batch-16 shapes against their
             plain versions and timed (K1 beside SDPA and K2 beside its
             bound also by device time, as in phase 9; the bfloat16 K2
             too), and K4 at
             the iSTFT vocoder's six
             shapes at batch 1 too (each beside cuDNN autotuned, TF32
             off);
17. evaluate evaluate --objective 2 --save_dir on phase 13's features
             with 2 clips held out (finite MCD and F0 rows; 10 K1 + 10 K2
             per acoustic forward, 6 K4 per vocoder forward) and
             prosody_sweep at 0.8/1.0/1.2 in both control modes on the
             README sentence (reported) and on the corpus's first
             train.txt sentence (verify passes);
18. parallel two ranks on cuda:0 over gloo (NCCL refuses two ranks on one
             GPU), full width, phase 13's features, dropout 0, against the
             one-process steps on the same batches (run on rank 0): PAR_STEPS
             steps at dp 2 (5 rows a rank) at float32 and bfloat16 and at
             tp 2 (one head per rank: K1 and K3 at [10, 1, L, 128]), the
             float32 gradient per tensor against its own noise (two
             reordered one-process steps), each rank's K1/K3 launches;
             train() under dp 2 (rank 0 alone logs and writes the whole
             checkpoint; the preemption check's host time); the GAN step
             at --data_parallel 2
             (batch 16 x 8192, 8 a rank); K1 and K3 at one head against
             their plain versions, timed beside SDPA;
19. replicas a Synthesizer over [cuda:0, cuda:0]: a [16 x 128] dispatch
             (one graph per replica at [8 x 128]) against one replica
             (whole int16 wavs), 10 K1 + 10 K2 + 6 K4 per replica;
             serve_cli --data_parallel 2 refuses one card;
20. g2p      mine_lexicon on the tracked metadata; train_g2p on the
             tracked mined lexicon (G2P_EPOCHS epochs, batch 512, 500
             held out: greedy, beam-4 and rule accuracy, beam 4 must beat
             the rules); the written npz through NeuralG2P and the README
             sentence's frontend;
21. loo      one leave-one-out fold at a cut through the port's CLIs, then
             the vocoder ladder on the tracked snapshot and the fold's
             checkpoint.

The bfloat16 instances (--dtype bfloat16, the JAX train CLI's default) run
through the same script: the build reports their registers, spills and
tensor-core instructions (every bfloat16 instance is a wgmma kernel); after
phase 5, K1, K2 and K3 at bfloat16 are held against their plain versions
at every path shape (K3 also once at [2, 2, 2000, 128]; K2 also at
serving's shapes and under every plan it can pick), each launched twice
(bitwise equal); after phase 8, the README sentence goes through the synthesize
CLI's main with --dtype bfloat16 (10 bfloat16 K1 and K2 per forward, no
float32 ones; the mel against the same forward with the plain versions);
phase 9 times the bfloat16 instances beside SDPA at bfloat16 (K1 and K2
at batch mode's shapes and K2 at the re-dispatch's and every shape of
K2_SHAPES too, K2 also by device time); after phase
12, the train CLI trains 20 steps at its default dtype (bfloat16; 10
bfloat16 K1 and K3 per step) and 5 steps twice from one seed must agree
exactly.

The last line is {"ok": true, "device": {...}}.  Outputs go to a temporary
directory.  Without a CUDA device, or outside a checkout of the repository,
the script exits non-zero before printing any result.
"""

import contextlib
import faulthandler
import functools
import io
import itertools
import json
import math
import os
import re
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
# the README sentence's float32 mel on the card against the JAX package's
# on the CPU (the committed fixture): 3xTF32 kernels against XLA's float32
# through 10 FFT blocks and the PostNet, as MEL_ATOL holds the kernels
# against their plain versions (the port on the CPU lies within 5.7e-06)
README_MEL_ATOL = 1e-3
# the data-preparation phase: the tracked clips, TextGrids and stats
PREP_RAW = "raw_data/LJSpeech10/LJSpeech"
PREP_TEXTGRIDS = "preprocessed_data/LJSpeech10/TextGrid/LJSpeech"
PREP_STATS = "preprocessed_data/LJSpeech10/stats.json"
# stats.json made on the card from the tracked TextGrids against the
# tracked one: calibrated on the CPU, where the JAX package's Preprocessor
# reproduces the tracked file exactly and the port's lies within 3.503e-05
# of it (the pitch mean, in Hz; the other seven numbers within 2.8e-05);
# the card adds cuFFT's rounding to PocketFFT's
PREP_STATS_ATOL = 1e-3
# the card's features against the port's own CPU run (cuFFT against
# PocketFFT): the mel before its log relative to its largest value, and
# the normalized phone energy, absolute (the log-mel is printed: the log
# of bins near the 1e-5 clamp magnifies the FFTs' ~1e-8 differences)
PREP_FEATURE_TOL = 1e-4
# DIO on the card against the CPU: frames whose voicing agrees
F0_VOICING_SHARE = 0.99
PREP_STEPS = 20
PREP_SYNTH_STEP = 10
# vocoder training (phase 15) at full width, the CLI's defaults (batch 16,
# 8192-sample segments) on the documented fine-tuning recipe: C8C8I at 512
# channels from the tracked snapshot, the default MPD and MSD, mixed mels
VOC_CONFIG = "fastspeech2_tpu_torch/configs/hifigan/config_istft.json"
VOC_PARITY_CONFIG = "fastspeech2_tpu_torch/configs/hifigan/config.json"
VOC_MELGAN_CONFIG = "fastspeech2_tpu_torch/configs/hifigan/config_melgan.json"
VOC_MEL_WEIGHT = 135
VOC_BATCH, VOC_SEGMENT = 16, 8192
VOC_STEPS = 20
# the resumed run's steps, all inside one torch.profiler window
VOC_RESUME_STEPS = 5
# the other generator families and modes, briefly
VOC_BRIEF_STEPS = 3
VOC_SCAN_STEP, VOC_SCAN_TOTAL = 5, 10
VOC_REPRO_STEPS = 5
# training: the decoder's and encoder's L at LJSpeech lengths
# parallel training on one card (phase 18): two ranks on cuda:0 over gloo;
# the gates against the one-process steps (dropout 0): the six losses'
# relative error; the first step's gradient, each tensor's error over its
# largest |value| (floored at 1e-3 of the whole gradient's largest): at
# float32 within PAR_NOISE_X x that tensor's own float32 noise +
# PAR_GRAD_ABS, the noise being the largest error of three one-process
# steps equal to the first in exact arithmetic (the batch's rows reversed;
# the heads rotated, head and FFN channels shuffled; the convolutions
# without cuDNN), which must themselves stay within PAR_NOISE_MAX (else a
# reordering is not the same step); at bfloat16 within PAR_GRAD_TOL_BF16;
# the gradient's global norm; the state after the first and the last
# step: at most PAR_SHARE of the parameter
# elements off by more than PAR_PARAM_TOL of their tensor's largest
# |value| (Adam divides each gradient element by its own size: an element
# whose gradient sits at the noise steps either way), the BatchNorm
# statistics within PAR_PARAM_TOL (the running mean after the last step
# plus 0.2 x steps x the summed rates: it follows the conv biases of
# parallel_steps.ZERO_GRADIENT)
PAR_STEPS = 5
PAR_LOOP_STEPS = 6
PAR_GAN_STEPS = 2
PAR_LOSS_RTOL = 1e-4
# (a fault of the split, such as a dropped all-reduce, a partial gradient
# or a bias added twice, changes the function, not the order of a sum;
# most tensors' noise is 1e-6-1e-4, one reads 5.3e-3: PERF.md, PR 14)
PAR_NOISE_X = 4
PAR_GRAD_ABS = 1e-4
PAR_NOISE_MAX = 5e-2
PAR_PARAM_TOL = 1e-4
PAR_SHARE = 1e-2
# at bfloat16 the rows' activations round apart as the batch is split
# (cuBLAS picks its kernels by shape): the statistics to a few bfloat16
# ulps (2^-8)
PAR_LOSS_RTOL_BF16 = 1e-2
PAR_GRAD_TOL_BF16 = 5e-2
PAR_PARAM_TOL_BF16 = 5e-2
PAR_SHARE_BF16 = 1e-2
# the GAN step at --data_parallel 2: each parameter's error over its
# tensor's largest |value| (floored at 1e-3) after PAR_GAN_STEPS steps
PAR_GAN_TOL = 1e-2
# serving over two replicas against one (phase 19): int16 LSB
REPLICA_LSB = 1
# the G2P trainer (phase 20): cut from the JAX CLI's default 300 epochs
# to keep the run short (an epoch takes 1.1-1.4 s on the H100; 60 until
# the scan sub-phase's float32 run took its place in the run's time)
G2P_EPOCHS = 30
# leave-one-out at a cut (phase 21): acoustic steps, vocoder steps per stage
LOO_ACOUSTIC_STEPS = 4
LOO_VOC_STEPS = 2
TRAIN_BATCH = 10
TRAIN_STEPS = 20
# phase 10's scan sub-phase: train.yaml's step block (scan_step 500) with
# these steps and duty periods, K = gcd(500, 5) = 5, and a mel bucket that
# splits the corpus into two shape groups; its budget on the card
SCAN_STEPS = 20
SCAN_LOG_STEP = 5
SCAN_K = 5
SCAN_MEL_BUCKET = 512
SCAN_BUDGET_S = 60
# the float32 scan run's steps (K = SCAN_K)
SCAN_F32_STEPS = 10
# the scan run's steps inside its torch.profiler window (the busy share):
# steps 11-20, each a replay (both groups' graphs are captured by step 6);
# the ms a step are also read over these steps
SCAN_WINDOW = (10, 20)
# every kernel's least time (tools/kernel_bounds.py: H100 SXM peaks from
# NVIDIA's data sheet)
BOUND_BASIS = ("3xTF32 on the tensor cores: max(3 x operations / 495 "
               "TFLOP/s, bytes / 3.35 TB/s)")
BOUND_BASIS_BF16 = ("BF16 on the tensor cores: max(operations / 989 "
                    "TFLOP/s, bytes of bfloat16 / 3.35 TB/s)")
BOUND_BASIS_K3_BF16 = ("BF16 for S and dP, 3xBF16 for the products with "
                       "P and dS (a float32 operand times a bfloat16 one; "
                       "cheaper than 2xTF32 at 495 TFLOP/s): max(2/5 x "
                       "operations / 989 TFLOP/s + 3 x 3/5 x operations / "
                       "989 TFLOP/s, bytes of bfloat16 / 3.35 TB/s)")
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
# the K1 wrapper's host time: calls issued back to back per run, and runs
K1_HOST_CALLS = 100
K1_HOST_REPS = 7
# the attention kernels' SASS functions: float32 K1 and its key-split
# combine; K3's D = rowsum(G o O) and its main kernel (K3a's dQ blocks and
# K3b's dK, dV blocks); bfloat16 K1 and its combine; K3a (D and dQ) and
# K3b (dK, dV)
ATTENTION_KERNELS = ("mha_fwd_f32_kernel", "mha_fwd_combine_kernel",
                     "mha_bwd_rowdot_f32_kernel", "mha_bwd_f32_kernel",
                     "mha_fwd_bf16_kernel", "mha_fwd_combine_bf16_kernel",
                     "mha_bwd_dq_bf16_kernel", "mha_bwd_dkdv_bf16_kernel")
# the convolution kernels' SASS functions (templates: several instances
# each): K4's conv (both convs of a dilation unit), the float32 K2's two
# convs (one template), the bfloat16 K2's two convs (one template; its
# partial-sum and LayerNorm kernels do no product)
CONV_KERNELS = ("resblock_wgmma_kernel", "ffn_wgmma_kernel",
                "ffn_bf16_kernel")
# the kernels that multiply, all built on wgmma: each must hold HGMMA and
# no HMMA (every kernel instance has had its Hopper redesign)
WGMMA_KERNELS = ("mha_fwd_bf16_kernel", "mha_bwd_dq_bf16_kernel",
                 "mha_bwd_dkdv_bf16_kernel", "resblock_wgmma_kernel",
                 "mha_fwd_f32_kernel", "ffn_wgmma_kernel",
                 "mha_bwd_f32_kernel", "ffn_bf16_kernel")
# a run still going after this many seconds has hung: it prints every
# thread's stack and exits non-zero, inside the 1,200 s a run may take
HANG_S = 1100
RUN_CEILING_S = 800
# an instance of K4's kernel by its mangled template arguments: output
# channels per block, and the first (1) or second (0) conv of a unit
K4_INSTANCE = re.compile(r"resblock_wgmma_kernelILi(\d+)ELb([01])E")
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


def device_times(fn, prefix="", iters=20, warmup=3):
    """-> {prefix + "dev_ms": device ms per fn() call, prefix + "prof_ms":
    the profiler's ms per call}.  The
    first: CUDA events around ``iters`` calls queued behind a sleeping
    kernel (torch.cuda._sleep), so that the host has issued them all before
    the first one starts and the card runs them back to back: no host time,
    the gaps between kernels included; the sleep is lengthened until it
    outlasts the host's issue.  The second: the self device time of the
    kernels in a torch.profiler window (CUDA activity), no gap included;
    late in a run, after other profiler windows in the process, its
    windows have lost kernel events (PERF.md), so the first is the one
    held against a bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 2_000_000
    for _ in range(6):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(cycles)
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        torch.cuda.synchronize()
        if host_ms < 0.8 * marks[0].elapsed_time(marks[1]):
            break
        cycles *= 4
    queued = marks[1].elapsed_time(marks[2]) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    profiled = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) \
        / iters / 1e3
    return {prefix + "dev_ms": queued, prefix + "prof_ms": profiled}


def k1_host_times(device):
    """K1's wrapper at the small shapes, [1, 2, 32, 128] (inference) and
    [10, 2, 128, 128] (training, with the row statistics), float32 and
    bfloat16: -> {(dtype, B, L, stats): (host microseconds per call, the
    kernel's own microseconds, the CUDA-event time per call of
    back-to-back calls as cuda_time_ms takes it)}.  The host time is the
    median over K1_HOST_REPS runs of the wall time of K1_HOST_CALLS calls
    issued back to back divided by their number (the host is shared: one
    run can read a third more); the kernel's is the median of CUDA events
    around single calls, each issued while the card sleeps
    (torch.cuda._sleep) so that the events time the kernel and not the
    host's enqueue."""
    import torch

    from fastspeech2_tpu_torch.ops import cuda_attention

    found = {}
    for dt in (torch.float32, torch.bfloat16):
        for B, L, stats in ((1, 32, False), (TRAIN_BATCH, 128, True)):
            q, k, v, mask = attention_inputs([L] * B, L, device, seed=L)
            q, k, v = (t.to(dt) for t in (q, k, v))

            def call():
                cuda_attention._launch_forward(q, k, v, mask, stats)

            for _ in range(5):
                call()
            torch.cuda.synchronize()
            runs = []
            for _ in range(K1_HOST_REPS):
                t0 = time.perf_counter()
                for _ in range(K1_HOST_CALLS):
                    call()
                runs.append((time.perf_counter() - t0) / K1_HOST_CALLS * 1e6)
                torch.cuda.synchronize()
            host = statistics.median(runs)
            kernel = []
            for _ in range(21):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(1_000_000)   # ~0.6 ms of card time
                a.record()
                call()
                b.record()
                torch.cuda.synchronize()
                kernel.append(a.elapsed_time(b) * 1e3)
            found[(str(dt).split(".")[1], B, L, stats)] = (
                host, statistics.median(kernel), cuda_time_ms(call) * 1e3)
    return found


def with_bound(t, bound, basis=BOUND_BASIS):
    """t + the bound of one of tools/kernel_bounds.py's functions (3xTF32
    on the tensor cores unless ``basis`` names another), the SIMT float32
    bound beside it."""
    t["bound_ms"], t["bound_by"], t["simt_bound_ms"] = bound[:3]
    t["bound_basis"] = basis
    return t


def ptxas_entries(report):
    """-> {entry function's mangled name: {registers, spill_bytes}}, one per
    template instance, from nvcc -Xptxas -v."""
    rows = {}
    current = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1] if "'" in line else line
            rows[current] = dict(registers=0, spill_bytes=0)
        elif current and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            rows[current]["spill_bytes"] += nums[1] + nums[2]
        elif current and "Used" in line and "registers" in line:
            rows[current]["registers"] = int(
                line.split("Used")[1].split()[0])
    return rows


def ptxas_by_kernel(report, names):
    """-> {kernel: {instances, max_registers, spill_bytes}} over all the
    template instances of each kernel, from nvcc -Xptxas -v."""
    out = {n: dict(instances=0, max_registers=0, spill_bytes=0)
           for n in names}
    for entry, row in ptxas_entries(report).items():
        name = next((n for n in names if n in entry), None)
        if name:
            out[name]["instances"] += 1
            out[name]["max_registers"] = max(out[name]["max_registers"],
                                             row["registers"])
            out[name]["spill_bytes"] += row["spill_bytes"]
    return out


def sass_functions(lib_path):
    """-> [(function name, its SASS)] of the library, or None without
    cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    return [tuple(block.split("\n", 1)) for block in
            sass.split("Function : ")[1:]]


def tensor_core_counts(sass):
    """-> {"HMMA": n, "HGMMA": m} in one function's SASS."""
    lines = sass.splitlines()
    return {"HMMA": sum(" HMMA." in ln for ln in lines),
            "HGMMA": sum(" HGMMA." in ln for ln in lines)}


def hmma_counts(lib_path, names):
    """-> {kernel: {"HMMA": n, "HGMMA": m}}, the tensor-core instructions in
    its SASS (HMMA: mma.sync; HGMMA: wgmma), or None without cuobjdump."""
    functions = sass_functions(lib_path)
    if functions is None:
        return None
    counts = {}
    for head, body in functions:
        name = next((n for n in names if n in head), None)
        if name:
            c = counts.setdefault(name, {"HMMA": 0, "HGMMA": 0})
            for key, n in tensor_core_counts(body).items():
                c[key] += n
    return counts


def k4_instances(report, lib_path, lib):
    """-> one row per instance of K4's kernel: output channels per block,
    first or second conv, registers and spill bytes (nvcc -Xptxas -v), the
    block's dynamic shared memory (fs2_resblock_smem_bytes) and its SASS's
    HGMMA and HMMA counts (None without cuobjdump)."""
    rows = {}
    for entry, row in ptxas_entries(report).items():
        m = K4_INSTANCE.search(entry)
        if m:
            nb = int(m.group(1))
            rows[nb, m.group(2) == "1"] = dict(
                nb=nb, first=m.group(2) == "1", **row,
                smem_bytes=lib.fs2_resblock_smem_bytes(nb), HGMMA=None,
                HMMA=None)
    for head, body in sass_functions(lib_path) or ():
        m = K4_INSTANCE.search(head)
        if m and (int(m.group(1)), m.group(2) == "1") in rows:
            rows[(int(m.group(1)), m.group(2) == "1")].update(
                tensor_core_counts(body))
    return [rows[key] for key in sorted(rows)]


def wgmma_instances(report, lib_path, lib):
    """-> one row per instance of the kernels redesigned for Hopper after
    K4 (the float32 K1; the float32 K2's conv1 and conv2,
    ffn_wgmma_kernel<false|true>; the float32 K3's main kernel, K3a's and
    K3b's blocks; the bfloat16 K2's conv1 and conv2,
    ffn_bf16_kernel<false|true>): registers and spill
    bytes (nvcc -Xptxas -v), the block's dynamic shared memory, and its
    SASS's HGMMA and HMMA counts (None without cuobjdump)."""
    smem = {"mha_fwd_f32_kernel": lib.fs2_mha_fwd_f32_smem_bytes(),
            "ffn_wgmma_kernelILb0E": lib.fs2_conv_ffn_f32_smem_bytes(0),
            "ffn_wgmma_kernelILb1E": lib.fs2_conv_ffn_f32_smem_bytes(1),
            "mha_bwd_f32_kernel": lib.fs2_mha_bwd_f32_smem_bytes(),
            "ffn_bf16_kernelILb0E": lib.fs2_conv_ffn_bf16_smem_bytes(),
            "ffn_bf16_kernelILb1E": lib.fs2_conv_ffn_bf16_smem_bytes()}
    names = {"mha_fwd_f32_kernel": "K1 f32",
             "ffn_wgmma_kernelILb0E": "K2 f32 conv1",
             "ffn_wgmma_kernelILb1E": "K2 f32 conv2",
             "mha_bwd_f32_kernel": "K3 f32",
             "ffn_bf16_kernelILb0E": "K2 bf16 conv1",
             "ffn_bf16_kernelILb1E": "K2 bf16 conv2"}
    rows = {}
    for entry, row in ptxas_entries(report).items():
        key = next((k for k in names if k in entry), None)
        if key:
            rows[key] = dict(kernel=names[key], **row, smem_bytes=smem[key],
                             HGMMA=None, HMMA=None)
    for head, body in sass_functions(lib_path) or ():
        key = next((k for k in names if k in head), None)
        if key in rows:
            rows[key].update(tensor_core_counts(body))
    return [rows[key] for key in names if key in rows]


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


def graph_counts(synth):
    """-> (the launches its graphs' replays made, what the wrappers counted
    while its graphs were made) of a Synthesizer; empty without graphs."""
    graphs = getattr(synth, "graphs", None)
    if graphs is None:
        return {}, {}
    return graphs.launches(), dict(graphs.setup_launches)


@contextlib.contextmanager
def record_forwards():
    """Wrap ``Synthesizer.infer_ids`` and ``Synthesizer.synthesize_ids`` (the
    unfused and the fused dispatch: every acoustic forward of the CLI's
    modes goes through one of them): each call's arguments, output and the
    launches it made (one acoustic forward, or two with a re-dispatch).  A
    fused call's launches are its graph replays' (captured launches times
    replays) plus its eager ones; ``setup`` holds what the wrappers counted
    while it made a graph (the warm-up run and the capture)."""
    from fastspeech2_tpu_torch.synthesis.pipeline import Synthesizer

    calls = []
    inner = Synthesizer.infer_ids
    inner_fused = Synthesizer.synthesize_ids

    def infer_ids(self, *args, **kwargs):
        before = launch_counts()
        out = inner(self, *args, **kwargs)
        after = launch_counts()
        calls.append(dict(synth=self, args=args, kwargs=kwargs, out=out,
                          launches={k: after[k] - before[k]
                                    for k in after}))
        return out

    def synthesize_ids(self, *args, **kwargs):
        before, (replay0, setup0) = launch_counts(), graph_counts(self)
        wavs, out = inner_fused(self, *args, **kwargs)
        after, (replay1, setup1) = launch_counts(), graph_counts(self)
        setup = {k: setup1.get(k, 0) - setup0.get(k, 0) for k in after}
        calls.append(dict(
            synth=self, args=args, kwargs=kwargs, out=out, fused=True,
            setup=setup,
            launches={k: after[k] - before[k] - setup[k]
                      + replay1.get(k, 0) - replay0.get(k, 0)
                      for k in after}))
        return wavs, out

    Synthesizer.infer_ids = infer_ids
    Synthesizer.synthesize_ids = synthesize_ids
    try:
        yield calls
    finally:
        Synthesizer.infer_ids = inner
        Synthesizer.synthesize_ids = inner_fused


@contextlib.contextmanager
def record_kernel_inputs():
    """Wrap the launch points of K1, K3 and K2 and the parity-net ResBlock's
    call of K4: a copy of the inputs of the first launch at each (kernel,
    dtype, shape), so that every shape a driven path gave a kernel can be
    held against its plain version afterwards (check_recorded_inputs)
    -> {key: inputs}."""
    import torch

    from fastspeech2_tpu_torch.models import hifigan
    from fastspeech2_tpu_torch.ops import cuda_attention, cuda_ffn

    seen = {}

    def keep(key, *args):
        # inside a CUDA graph's capture nothing runs: the warm-up step
        # before it gave the same kernel the same shapes
        if key not in seen and not torch.cuda.is_current_stream_capturing():
            seen[key] = [[t.detach().clone() for t in a]
                         if isinstance(a, (list, tuple))
                         else a.detach().clone() for a in args]

    k1, k3, k2, k4 = (cuda_attention._launch_forward,
                      cuda_attention.fused_attention_backward, cuda_ffn._launch,
                      hifigan.fused_resblock)

    def forward(q, k, v, mask, with_stats):
        keep(("K1", q.dtype, tuple(q.shape)), q, k, v, mask)
        return k1(q, k, v, mask, with_stats)

    def backward(q, k, v, mask, out, row_max, row_sum, g):
        keep(("K3", q.dtype, tuple(q.shape)), q, k, v, mask, g)
        return k3(q, k, v, mask, out, row_max, row_sum, g)

    def ffn(x, w1, b1, w2, b2, ln_scale, ln_bias, packed, plan=None):
        keep(("K2", x.dtype, tuple(x.shape), w2.shape[0]), x, w1, b1, w2, b2,
             ln_scale, ln_bias)
        return k2(x, w1, b1, w2, b2, ln_scale, ln_bias, packed, plan)

    def resblock(x, w1, b1, w2, b2, dilations, packed=None):
        keep(("K4", x.dtype, tuple(x.shape), w1[0].shape[-1],
              tuple(dilations)), x, w1, b1, w2, b2)
        return k4(x, w1, b1, w2, b2, dilations, packed=packed)

    cuda_attention._launch_forward = forward
    cuda_attention.fused_attention_backward = backward
    cuda_ffn._launch = ffn
    hifigan.fused_resblock = resblock
    try:
        yield seen
    finally:
        cuda_attention._launch_forward = k1
        cuda_attention.fused_attention_backward = k3
        cuda_ffn._launch = k2
        hifigan.fused_resblock = k4


def check_recorded_inputs(seen, where, card):
    """Each recorded kernel input (record_kernel_inputs) launched again on
    the card and held against the plain version on the same tensors:
    float32 K1 and K2 to KERNEL_ATOL absolute, K3 to K3_RTOL and K4 to
    K4_RTOL of the largest |plain value|, bfloat16 to BF16_ULPS.  Raises on
    a failed gate -> {key: error}."""
    import torch

    from fastspeech2_tpu_torch.ops import (
        cuda_attention,
        cuda_ffn,
        cuda_resblock,
    )
    from fastspeech2_tpu_torch.ops.attention import (
        multi_head_attention,
        plain_attention_backward,
    )

    errors, failed = {}, []
    extra = {"K1": (), "K3": (), "K2": ("k2",), "K4": ("k", "dilations")}
    for key, args in seen.items():
        name, dtype = key[0], key[1]
        if name == "K1":
            got = [cuda_attention._launch_forward(*args, False)]
            ref = [multi_head_attention(*args)]
        elif name == "K3":
            q, k, v, mask, g = args
            fwd = cuda_attention._launch_forward(q, k, v, mask, True)
            got = cuda_attention.fused_attention_backward(q, k, v, mask,
                                                          *fwd, g)
            ref = plain_attention_backward(q, k, v, mask, g)
        elif name == "K2":
            packed = cuda_ffn.pack_ffn_weights(args[1], args[3], dtype)
            got = [cuda_ffn._launch(*args, packed=packed)]
            ref = [cuda_ffn.plain_conv_ffn(*args)]
        else:
            with torch.inference_mode():
                got = [cuda_resblock.fused_resblock(*args, key[4])]
                ref = [cuda_resblock.plain_resblock(*args, key[4])]
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            err = max(bf16_ulps(a, b) for a, b in zip(got, ref))
            tol = BF16_ULPS
        elif name in ("K1", "K2"):
            err = max((a - b).abs().max().item() for a, b in zip(got, ref))
            tol = KERNEL_ATOL
        else:
            err = max(((a - b).abs().max() / b.abs().max()).item()
                      for a, b in zip(got, ref))
            tol = K3_RTOL if name == "K3" else K4_RTOL
        finite = all(torch.isfinite(a.float()).all() for a in got)
        errors[key] = err
        if not (finite and err <= tol):
            failed.append((key, err, tol))
    say(f"[{where}] every kernel input the path gave, launched again and "
        f"held against its plain version on the card (float32 K1, K2 "
        f"absolute, tolerance {KERNEL_ATOL:g}; K3, K4 relative to the "
        f"largest |value|, {K3_RTOL:g}, {K4_RTOL:g}; bfloat16 in ulps at "
        f"the largest |value|, {BF16_ULPS}): "
        + "; ".join(f"{k[0]} {str(k[1])[6:]} {list(k[2])}"
                    f"{''.join(f' {n}={x}' for n, x in zip(extra[k[0]], k[3:]))}"
                    f" {e:.3g}" for k, e in errors.items()) + f" on {card}")
    if failed:
        raise RuntimeError(f"[{where}] kernels disagree with their plain "
                           f"versions at the path's inputs: {failed}")
    return errors


def profiled_stages(fn, names, path):
    """fn() once in a torch.profiler window that records Python calls
    -> (its result, {name: calls, host ms, kernels launched and their
    device ms}, kernels in the window, their device ms).  A stage is every
    call of the Python function of that name; its kernels are those
    launched inside one of its calls.  The trace goes to ``path`` and is
    removed."""
    import bisect

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True) as prof:
        out = fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    spans = {n: [] for n in names}
    for e in events:
        if e.get("cat") == "python_function":
            n = e.get("name", "").rsplit(": ", 1)[-1]
            if n in spans:
                spans[n].append((e["ts"], e["ts"] + e["dur"]))
    launched_at = {e["args"]["correlation"]: e["ts"] for e in events
                   if e.get("cat") == "cuda_runtime"
                   and "correlation" in e.get("args", {})}
    kernels = [(launched_at.get(e.get("args", {}).get("correlation")),
                e["dur"]) for e in events if e.get("cat") == "kernel"]
    stages = {}
    for n, ss in spans.items():
        ss.sort()
        starts = [s for s, _ in ss]

        def inside(ts):
            if ts is None:
                return False
            i = bisect.bisect_right(starts, ts) - 1
            return i >= 0 and ts <= ss[i][1]

        mine = [d for ts, d in kernels if inside(ts)]
        stages[n] = dict(calls=len(ss),
                         host_ms=sum(e - s for s, e in ss) / 1e3,
                         launches=len(mine), device_ms=sum(mine) / 1e3)
    return out, stages, len(kernels), sum(d for _, d in kernels) / 1e3


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
    and batch mode give; K3 at the training shapes and once at [2, 2, 2000,
    128] (its scratch no longer grows as L^2).  Raises on a failed gate ->
    {kernel: (largest error in ulps, largest absolute error)}."""
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
    for B, L in ((TRAIN_BATCH, 1000), (TRAIN_BATCH, 768),
                 (TRAIN_BATCH, 128), (2, 2000)):
        q, k, v, mask, g = (t.to(bf16) if t.is_floating_point() else t
                            for t in attention_grad_inputs(L, device,
                                                           seed=L + 21, B=B))
        fwd = [cuda_attention._launch_forward(q, k, v, mask, True)
               for _ in range(2)]
        bwd = [cuda_attention.fused_attention_backward(q, k, v, mask,
                                                       *fwd[0], g)
               for _ in range(2)]
        torch.cuda.synchronize()
        where = f"[{B}, 2, {L}, 128]"
        record("K1", fwd[0][0], fwd[1][0], multi_head_attention(q, k, v,
                                                                mask), where)
        repeat["K1"] = repeat["K1"] and all(
            torch.equal(a, b) for a, b in zip(fwd[0][1:], fwd[1][1:]))
        for a, b, ref in zip(*bwd, plain_attention_backward(q, k, v, mask,
                                                            g)):
            record("K3", a, b, ref, where)
    # K2 under its own plan and under every plan it can pick (the first
    # conv's tap splits, the second conv's hidden groups), each twice
    k2_plans = 0
    for B, L, k2 in k2_shapes + ((16, 128, 1), (16, 1000, 1)):
        args = ffn_inputs(L, device, seed=L + k2 + B + 1, k2=k2, B=B)
        args = (args[0].to(bf16),) + args[1:]
        ref = cuda_ffn.plain_conv_ffn(*args)
        got = cuda_ffn.fused_conv_ffn(*args)
        again = cuda_ffn.fused_conv_ffn(*args)
        torch.cuda.synchronize()
        record("K2", got, again, ref, f"[{B}, {L}, 256], k2={k2}")
        packed = cuda_ffn.pack_ffn_weights(args[1], args[3], bf16)
        for plan in itertools.product((1, 3, 9), (1, 2, 4, 8, 16)):
            got, again = (cuda_ffn._launch(*args, packed=packed, plan=plan)
                          for _ in range(2))
            torch.cuda.synchronize()
            record("K2", got, again, ref,
                   f"[{B}, {L}, 256], k2={k2}, plan {plan}")
            k2_plans += 1
    say(f"[bf16] K1 at [1|2, 2, 32|48|1000, 128] (partly and fully padded "
        f"rows), batch mode's [B, 2, L, 128] and [10, 2, 1000|768|128, "
        f"128] and [2, 2, 2000, 128] with the row statistics; K2 at (B, L, "
        f"k2) in {k2_shapes} and serving's [16, 128|1000] (own plan and "
        f"{k2_plans} forced plans: tap splits 1|3|9 x hidden groups "
        f"1|2|4|8|16); K3 at [10, 2, 1000|768|128, 128] and [2, 2, "
        f"2000, 128]; each against its plain "
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

        # long: three sentences as one batch, joined with 120 ms pauses: one
        #    fused text->wav dispatch, eager (no warmup, so no graph)
        ([joined], chunks, [path]), totals, calls, lines, cli_s = \
            drive_cli(argv(LONG_TEXT) + ["--long"])
        if len(calls) != 1 or not calls[0].get("fused"):
            raise RuntimeError(f"[long] {len(calls)} dispatches, expected "
                               "one fused dispatch")
        launches, setup = calls[0]["launches"], calls[0]["setup"]
        # the vocoder runs in each fused dispatch, a re-dispatch's too
        need = int(calls[0]["out"].duration_rounded.sum(dim=1).max())
        forwards = check_launches(
            "long", calls, launches, 6,
            2 if need > model_config["max_seq_len"] else 1)
        if totals != launches or any(setup.values()):
            raise RuntimeError(f"[long] the wrappers counted {totals}, "
                               f"{setup} of them making a graph: expected "
                               "the eager dispatch's launches and no graph")
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


def readme_fixture_check(device, card):
    """The README sentence's float32 acoustic forward on the card against
    the JAX package's float32 result on the CPU (the committed
    reference_data/readme_sentence_jax.npz): IDs and durations exactly,
    bucket ids exactly unless JAX's value lies within
    readme_reference.BOUNDARY_MARGIN of a bin edge, the mel within
    README_MEL_ATOL.  Raises on a failed gate -> the report."""
    from fastspeech2_tpu_torch.tools import readme_reference

    got, bins = readme_reference.port_forward(device)
    report = readme_reference.compare(got, readme_reference.load_fixture(),
                                      bins)
    say(f"[readme fixture] {README_SENTENCE!r} on {ACOUSTIC_NPZ}, float32 "
        f"forward on the card against the JAX package's on the CPU "
        f"({os.path.relpath(readme_reference.FIXTURE)}): IDs equal "
        f"{report['ids_equal']}, durations equal "
        f"{report['durations_equal']}, bucket ids that differ (phone, "
        f"JAX's margin to the bin edge) {report['bucket_flips']} (allowed "
        f"only within {readme_reference.BOUNDARY_MARGIN:g} of an edge), "
        f"frames {report['mel_frames']}, mel after the PostNet "
        f"max_abs_diff={report['mel_max_abs_diff']:.3e} (tolerance "
        f"{README_MEL_ATOL:g}); on {card}")
    if not (report["ids_equal"] and report["durations_equal"]
            and report["flips_near_edge"]
            and report["mel_frames"][0] == report["mel_frames"][1]
            and report["mel_max_abs_diff"] <= README_MEL_ATOL):
        raise RuntimeError(f"the card's README forward disagrees with the "
                           f"JAX fixture: {report}")
    return report


def _frames(tier, sr, hop):
    """Each interval's frames, rounded as the Preprocessor rounds them."""
    return [int(round(iv.end_time * sr / hop) - round(iv.start_time * sr / hop))
            for iv in tier.intervals]


def _boundaries(tier, sr, hop):
    return [int(round(iv.end_time * sr / hop)) for iv in tier.intervals[:-1]]


def data_preparation(device, card, tmp):
    """The data-preparation phase on the card, in the directory ``tmp``,
    from the tracked raw clips to a trained step and the synthesized
    samples: the align CLI's
    align_corpus, the preprocess CLI (on the tracked TextGrids; also on
    the CPU, and DIO alone on both), PREP_STEPS steps through the train
    CLI at its default dtype on those features with the synth_step duty
    and --profile_dir, and evaluate --synth on the last checkpoint.  Each
    driven path has the launch counts set to 0 just before and read just
    after.  Raises on a failed gate -> {"launches": {path: counts},
    "timings": {...}, "features": the card's preprocess yaml, the train
    yaml, the step of the acoustic checkpoint it wrote and the copy of
    the features with 2 clips held out (eval_yaml)}."""
    import copy
    import shutil

    import numpy as np
    import torch

    from fastspeech2_tpu_torch.audio.dio import dio_f0
    from fastspeech2_tpu_torch.audio.wav import load_wav
    from fastspeech2_tpu_torch.cli import (
        align_cli,
        evaluate_cli,
        preprocess_cli,
        train_cli,
    )
    from fastspeech2_tpu_torch.models.hifigan_istft import (
        HiFiGANiSTFTGenerator,
    )
    from fastspeech2_tpu_torch.preprocessing.preprocessor import Preprocessor
    from fastspeech2_tpu_torch.preprocessing.textgrid import read_textgrid
    from fastspeech2_tpu_torch.training import loop as train_loop

    with open(f"{CONFIG}/preprocess.yaml") as f:
        base = yaml.safe_load(f)
    with open(f"{CONFIG}/train.yaml") as f:
        base_train = yaml.safe_load(f)
    pp = base["preprocessing"]
    hop, sr = pp["stft"]["hop_length"], pp["audio"]["sampling_rate"]
    clips = sorted(n[:-4] for n in os.listdir(PREP_RAW) if n.endswith(".wav"))
    launches, timings = {}, {}

    def synced():
        torch.cuda.synchronize()
        return time.perf_counter()

    with contextlib.ExitStack() as recording:
        raw = os.path.join(tmp, "raw")
        shutil.copytree(PREP_RAW, os.path.join(raw, "LJSpeech"))

        def config(name, textgrids=True, **preprocessing):
            cfg = copy.deepcopy(base)
            cfg["path"].update(raw_path=raw, preprocessed_path=os.path.join(
                tmp, name))
            cfg["preprocessing"].update(preprocessing)
            if textgrids:
                shutil.copytree(os.path.dirname(PREP_TEXTGRIDS), os.path.join(
                    tmp, name, "TextGrid"))
            path = os.path.join(tmp, f"{name}.yaml")
            with open(path, "w") as f:
                yaml.safe_dump(cfg, f)
            return cfg, path

        # 1. the forced aligner on the card, phones from the .lab files
        #    through the lexicon and the neural G2P; each EM iteration's
        #    loglik and time from its verbose lines
        cfg, _ = config("aligned", textgrids=False)
        printed = io.StringIO()
        zero_counts()
        t0 = synced()
        with contextlib.redirect_stdout(printed):
            written = align_cli.align_corpus(cfg, device=device)
        timings["align_s"] = synced() - t0
        launches["prep align"] = launch_counts()
        history = [(int(it), float(ll), float(ms)) for it, ll, ms in
                   re.findall(r"\[align\] iter (\d+): loglik (-?[\d.]+) "
                              r"\(([\d.]+) ms\)", printed.getvalue())]
        for it, ll, ms in history:
            say(f"[prep align] EM iteration {it}: total loglik {ll:.1f}, "
                f"{ms:.2f} ms (emissions, Viterbi, backtrack, statistics) "
                f"on {card}")
        # the same run again in a profiler window: each EM stage's host
        # time per iteration and the kernels it launched
        cfg, _ = config("aligned_profiled", textgrids=False)
        _, em_stages, em_kernels, em_device_ms = profiled_stages(
            lambda: align_cli.align_corpus(cfg, device=device,
                                           verbose=False),
            ("_emissions", "_viterbi_forward", "_backtrack", "_accumulate"),
            os.path.join(tmp, "align_trace.json"))
        timings["em_stages"] = {
            k[1:]: {m: v[m] / max(v["calls"], 1) for m in
                    ("host_ms", "launches", "device_ms")}
            for k, v in em_stages.items()}
        near = total = 0
        for path in written:
            clip = os.path.basename(path)[: -len(".TextGrid")]
            n = len(load_wav(os.path.join(PREP_RAW, f"{clip}.wav"), sr)[0])
            tier = read_textgrid(path).get_tier_by_name("phones")
            frames = _frames(tier, sr, hop)
            if sum(frames) != n // hop + 1 or min(frames) <= 0:
                raise RuntimeError(f"[prep align] {clip}: durations {frames} "
                                   f"do not partition {n // hop + 1} frames")
            mine = _boundaries(tier, sr, hop)
            ref = _boundaries(read_textgrid(os.path.join(
                PREP_TEXTGRIDS, f"{clip}.TextGrid")).get_tier_by_name(
                    "phones"), sr, hop)
            total += len(ref)
            near += sum(any(abs(b - m) <= 1 for m in mine) for b in ref)
        lls = [ll for _, ll, _ in history]
        timings["em_iteration_ms"] = statistics.median(
            ms for _, _, ms in history)
        timings["boundary_share"] = near / max(total, 1)
        say(f"[prep align] align_cli.align_corpus on the card: "
            f"{len(written)} clips, {len(history)} EM iterations, "
            f"{timings['align_s']:.2f} s in all (features, G2P, EM, "
            f"TextGrids), median {timings['em_iteration_ms']:.2f} ms per "
            f"iteration; again under torch.profiler, per EM iteration, "
            f"each stage's host ms, kernels launched and their device ms "
            f"{({k: {m: round(x, 3) for m, x in v.items()} for k, v in timings['em_stages'].items()})}"
            f" ({em_kernels} kernels, {em_device_ms:.2f} ms of device "
            f"time in that whole run); durations partition every clip's "
            f"frames; "
            f"{near} of {total} tracked phone boundaries "
            f"({100 * timings['boundary_share']:.1f}%) within 1 frame of "
            f"this alignment's (not gated: flat-start EM is sensitive to "
            f"its platform); launches {launches['prep align']} on {card}")
        if (len(written) != len(clips) or not history
                or not all(map(math.isfinite, lls))):
            raise RuntimeError(f"[prep align] {len(written)} TextGrids, "
                               f"logliks {lls}")

        # 2. the preprocess CLI on the card from the tracked TextGrids,
        #    the Preprocessor on the CPU, and DIO alone on both
        card_cfg, card_yaml = config("card")
        cpu_cfg, _ = config("cpu")
        zero_counts()
        t0 = synced()
        with contextlib.redirect_stdout(io.StringIO()):
            preprocess_cli.main([card_yaml])
        timings["preprocess_card_s"] = synced() - t0
        launches["prep preprocess"] = launch_counts()
        # the same clips again in a profiler window, into the copy that
        # evaluate --synth reads (2 clips held out): each stage's host time
        # and the kernels it launched
        eval_cfg, eval_yaml = config("eval", val_size=2)
        t0 = synced()
        _, stage_s, prep_kernels, prep_device_ms = profiled_stages(
            lambda: preprocess_cli.main([eval_yaml]),
            ("_prepare_utterance", "_dsp_batch", "dio_f0",
             "_finalize_utterance"), os.path.join(tmp, "prep_trace.json"))
        timings["preprocess_profiled_s"] = synced() - t0
        timings["preprocess_stages"] = stage_s
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            Preprocessor(cpu_cfg, "cpu").build_from_path()
        timings["preprocess_cpu_s"] = time.perf_counter() - t0

        def stats(cfg):
            with open(os.path.join(cfg["path"]["preprocessed_path"],
                                   "stats.json")) as f:
                return json.load(f)

        with open(PREP_STATS) as f:
            tracked = json.load(f)
        got = stats(card_cfg)
        stats_err = max(abs(a - b) for k in tracked
                        for a, b in zip(got[k], tracked[k]))
        feature_err = {"mel": 0.0, "log_mel": 0.0, "energy": 0.0,
                       "pitch": 0.0}
        durations_equal = True

        def feature(cfg, kind, clip):
            return np.load(os.path.join(cfg["path"]["preprocessed_path"],
                                        kind, f"LJSpeech-{kind}-{clip}.npy"))

        for clip in clips:
            durations_equal &= np.array_equal(
                feature(card_cfg, "duration", clip),
                feature(cpu_cfg, "duration", clip))
            a, b = (feature(c, "mel", clip).astype(np.float64)
                    for c in (card_cfg, cpu_cfg))
            feature_err["log_mel"] = max(feature_err["log_mel"],
                                         float(np.abs(a - b).max()))
            feature_err["mel"] = max(feature_err["mel"], float(
                np.abs(np.exp(a) - np.exp(b)).max() / np.exp(b).max()))
            for kind in ("energy", "pitch"):
                a, b = (feature(c, kind, clip) for c in (card_cfg, cpu_cfg))
                feature_err[kind] = max(feature_err[kind],
                                        float(np.abs(a - b).max()))
        # DIO on each clip's padded, trimmed wav: the card against the CPU
        prep = Preprocessor(card_cfg, device)
        wavs = [prep._prepare_utterance("LJSpeech", c)["wav_padded"]
                for c in clips]
        dio_f0(torch.as_tensor(wavs[0], dtype=torch.float32, device=device),
               sr, hop)     # cuFFT's plans
        voiced_same = frames_all = 0
        f0_rel = 0.0
        dio_ms = []
        for w in wavs:
            y = torch.as_tensor(w, dtype=torch.float32, device=device)
            t0 = synced()
            f0 = dio_f0(y, sr, hop)
            dio_ms.append((synced() - t0) * 1e3)
            ref = dio_f0(y.cpu(), sr, hop).numpy()
            f0 = f0.cpu().numpy()
            voiced_same += int(((f0 > 0) == (ref > 0)).sum())
            frames_all += len(ref)
            both = (f0 > 0) & (ref > 0)
            if both.any():
                f0_rel = max(f0_rel, float((np.abs(f0[both] - ref[both])
                                            / ref[both]).max()))
        voicing = voiced_same / frames_all
        timings["dio_ms"] = statistics.median(dio_ms)
        say(f"[prep preprocess] python -m fastspeech2_tpu_torch.cli."
            f"preprocess_cli on the card, {len(clips)} clips from the "
            f"tracked TextGrids: {timings['preprocess_card_s']:.2f} s "
            f"(the Preprocessor on the CPU: "
            f"{timings['preprocess_cpu_s']:.2f} s); again under "
            f"torch.profiler ({timings['preprocess_profiled_s']:.2f} s, "
            f"{prep_kernels} kernels, {prep_device_ms:.2f} ms of device "
            f"time), each stage's calls, host ms, kernels launched and "
            f"their device ms "
            f"{({k: {m: round(x, 3) for m, x in v.items()} for k, v in stage_s.items()})}"
            f"; stats.json against the "
            f"tracked {PREP_STATS}: max_abs_diff={stats_err:.3e} (tolerance "
            f"{PREP_STATS_ATOL:g}); card against CPU: durations equal "
            f"{durations_equal}, the mel before its log "
            f"{feature_err['mel']:.3e} of its largest value and the phone "
            f"energy {feature_err['energy']:.3e} (tolerance "
            f"{PREP_FEATURE_TOL:g} each), log-mel "
            f"{feature_err['log_mel']:.3e} and phone pitch "
            f"{feature_err['pitch']:.3e} (printed); DIO alone on the "
            f"{len(clips)} padded wavs: voicing agrees on "
            f"{100 * voicing:.2f}% of {frames_all} frames (at least "
            f"{100 * F0_VOICING_SHARE:g}%), F0 on jointly voiced frames "
            f"within {f0_rel:.3e} relative, dio_f0 per clip median "
            f"{timings['dio_ms']:.2f} ms (min {min(dio_ms):.2f}, max "
            f"{max(dio_ms):.2f}) on {card}")
        if not (stats_err <= PREP_STATS_ATOL and durations_equal
                and feature_err["mel"] <= PREP_FEATURE_TOL
                and feature_err["energy"] <= PREP_FEATURE_TOL
                and voicing >= F0_VOICING_SHARE):
            raise RuntimeError("[prep preprocess] the card's features "
                               "disagree")

        # 3. PREP_STEPS steps through the train CLI at its default dtype on
        #    the card's features: synth_step duty every PREP_SYNTH_STEP
        #    steps with the iSTFT vocoder, --profile_dir
        train_cfg = copy.deepcopy(base_train)
        train_cfg["path"] = {k: os.path.join(tmp, "train", k) for k in
                             ("ckpt_path", "log_path", "result_path")}
        train_cfg["step"].update(total_step=PREP_STEPS, log_step=1,
                                 synth_step=PREP_SYNTH_STEP,
                                 val_step=10 ** 9, save_step=PREP_STEPS)
        train_yaml = os.path.join(tmp, "train.yaml")
        with open(train_yaml, "w") as f:
            yaml.safe_dump(train_cfg, f)
        profile_dir = os.path.join(tmp, "profile")
        steps, duties, vocoded = [], [], []
        inner_step, inner_synth = train_loop.train_step, \
            train_loop.synth_one_sample

        def recorded_step(model, optimizer, batch, step, grad_acc_step=1):
            before, t0 = launch_counts(), synced()
            losses = inner_step(model, optimizer, batch, step, grad_acc_step)
            end = synced()
            after = launch_counts()
            steps.append(dict(ms=(end - t0) * 1e3, shape=tuple(
                batch["mels"].shape[:2]) + (batch["texts"].shape[1],),
                launches={k: after[k] - before[k] for k in after},
                losses=[float(v) for v in losses]))
            return losses

        def recorded_synth(model, batch, *args, **kwargs):
            before, t0 = launch_counts(), synced()
            out = inner_synth(model, batch, *args, **kwargs)
            end = synced()
            after = launch_counts()
            duties.append(dict(ms=(end - t0) * 1e3, out=out,
                               mel_len=int(batch["mel_lens"][0]),
                               launches={k: after[k] - before[k]
                                         for k in after}))
            return out

        def vocoder_hook(module, args, output):
            if isinstance(module, HiFiGANiSTFTGenerator):
                vocoded.append(bool(torch.isfinite(output).all()))

        # every kernel input of the training, its duties and evaluate
        # --synth, held against the plain versions after evaluate
        seen = recording.enter_context(record_kernel_inputs())
        train_loop.train_step = recorded_step
        train_loop.synth_one_sample = recorded_synth
        hook = torch.nn.modules.module.register_module_forward_hook(
            vocoder_hook)
        printed = io.StringIO()
        zero_counts()
        t0 = synced()
        try:
            with contextlib.redirect_stdout(printed):
                _, _, final = train_cli.main([
                    "-p", card_yaml, "-m", f"{CONFIG}/model.yaml",
                    "-t", train_yaml, "--profile_dir", profile_dir,
                    "--vocoder_ckpt", VOCODER_NPZ])
        finally:
            train_loop.train_step = inner_step
            train_loop.synth_one_sample = inner_synth
            hook.remove()
        timings["train_s"] = synced() - t0
        launches["prep training"] = launch_counts()
        lines = printed.getvalue().splitlines()
        totals = [r["losses"][0] for r in steps]
        first5, last5 = (statistics.mean(totals[:5]),
                         statistics.mean(totals[-5:]))
        # steps 2-PREP_SYNTH_STEP: after the first, before the profiler
        # (steps 11-20) and with no duty inside the timed span
        timings["step_ms"] = statistics.median(
            r["ms"] for r in steps[1:PREP_SYNTH_STEP])
        timings["duty_ms"] = [d["ms"] for d in duties]
        per_step = {tuple(sorted(r["launches"].items())) for r in steps}
        want = {k: 0 for k in launches["prep training"]}
        step_want = tuple(sorted(dict(want, K1_bf16=10, K3_bf16=10).items()))
        duty_want = dict(want, K1_bf16=10, K2_bf16=10, K4=12)
        traces = (os.listdir(profile_dir) if os.path.isdir(profile_dir)
                  else [])
        kernel_names = set()
        n_kernel_events = 0
        kernel_us = {"K1": 0.0, "K3": 0.0, "all": 0.0}
        for name in traces:
            with open(os.path.join(profile_dir, name)) as f:
                events = json.load(f).get("traceEvents", [])
            kernels = [e for e in events if e.get("cat") == "kernel"]
            n_kernel_events += len(kernels)
            kernel_names |= {e.get("name", "") for e in kernels}
            for e in kernels:
                kernel_us["all"] += e.get("dur", 0.0)
                for k, p in (("K1", "mha_fwd"), ("K3", "mha_bwd")):
                    if p in e.get("name", ""):
                        kernel_us[k] += e.get("dur", 0.0)
        # the traced window holds PREP_STEPS - PREP_SYNTH_STEP steps
        timings["kernel_ms_per_step"] = {
            k: v / 1e3 / (PREP_STEPS - PREP_SYNTH_STEP)
            for k, v in kernel_us.items()}
        # the trace names each kernel by its demangled signature
        named = {k: sorted(n for n in kernel_names if p in n)
                 for k, p in (("K1", "mha_fwd"), ("K3", "mha_bwd"))}
        shapes = sorted({r["shape"] for r in steps})
        say(f"[prep train] python -m fastspeech2_tpu_torch.cli.train_cli at "
            f"its default dtype on the card's features: {final} steps at "
            f"(batch, mel frames, phones) {shapes} in "
            f"{timings['train_s']:.2f} s; median {timings['step_ms']:.2f} ms "
            f"per step over steps 2-{PREP_SYNTH_STEP} (host clock, device "
            f"synchronised); total loss mean of the first 5 steps "
            f"{first5:.4f}, of the last 5 {last5:.4f}; launches per step "
            f"{[{k: v for k, v in t if v} for t in per_step]}; synth_step "
            f"duties {len(duties)}: "
            f"{[dict(ms=round(d['ms'], 2), launches={k: v for k, v in d['launches'].items() if v}, wav=len(d['out'][2]), mel_len=d['mel_len']) for d in duties]}, "
            f"vocoder outputs finite {vocoded}; trace {traces} with "
            f"{n_kernel_events} kernel events of {len(kernel_names)} names, "
            f"device time per traced step (ms) "
            f"{({k: round(v, 3) for k, v in timings['kernel_ms_per_step'].items()})}, "
            f"naming K1 {named['K1']} and K3 {named['K3']}; last line "
            f"{lines[-1]!r}; on {card}")
        if final != PREP_STEPS or len(steps) != PREP_STEPS:
            raise RuntimeError(f"[prep train] trained {final} steps")
        if not all(math.isfinite(v) for r in steps for v in r["losses"]):
            raise RuntimeError("[prep train] a loss is not finite")
        if not last5 < first5:
            raise RuntimeError("[prep train] the loss did not fall")
        if per_step != {step_want}:
            raise RuntimeError(f"[prep train] launches per step {per_step}")
        if (len(duties) != PREP_STEPS // PREP_SYNTH_STEP
                or any(d["launches"] != duty_want for d in duties)):
            raise RuntimeError(f"[prep train] synth_step duties "
                               f"{[d['launches'] for d in duties]}, "
                               f"expected {duty_want} each")
        for d in duties:
            _, wav_rec, wav_pred = d["out"]
            if not (len(wav_rec) == len(wav_pred) == d["mel_len"] * hop
                    and np.abs(wav_pred).max() > 0):
                raise RuntimeError(f"[prep train] duty wavs "
                                   f"{len(wav_rec)}, {len(wav_pred)} for "
                                   f"mel_len {d['mel_len']}")
        if len(vocoded) != 2 * len(duties) or not all(vocoded):
            raise RuntimeError(f"[prep train] vocoder outputs {vocoded}")
        if not (traces and named["K1"] and named["K3"]):
            raise RuntimeError(f"[prep train] the trace {traces} does not "
                               f"name K1 and K3; its kernels: "
                               f"{sorted(kernel_names)[:20]}")
        launches["prep synth duty"] = duties[0]["launches"]

        # 4. evaluate --synth on the last checkpoint, with the preprocess
        #    config copy that holds out 2 clips (preprocessed again on the
        #    card above: the same features, another split)
        printed = io.StringIO()
        zero_counts()
        t0 = synced()
        with contextlib.redirect_stdout(printed):
            losses = evaluate_cli.main([
                "-p", eval_yaml, "-m", f"{CONFIG}/model.yaml", "-t",
                train_yaml, "--restore_step", str(PREP_STEPS), "--synth",
                "--vocoder_ckpt", VOCODER_NPZ])
        timings["evaluate_s"] = synced() - t0
        launches["prep evaluate --synth"] = launch_counts()
        base_name = os.path.join(train_cfg["path"]["result_path"],
                                 f"val_step_{PREP_STEPS}")
        wav_lens = []
        for kind in ("reconstructed", "synthesized"):
            with wave.open(f"{base_name}_{kind}.wav", "rb") as f:
                wav_lens.append(f.getnframes())
        eval_want = dict(want, K1=20, K2=20, K4=12)
        say(f"[prep evaluate] python -m fastspeech2_tpu_torch.cli."
            f"evaluate_cli --restore_step {PREP_STEPS} --synth on a copy "
            f"with val_size 2: losses "
            f"{[round(v, 4) for v in losses]}, wavs of {wav_lens} samples, "
            f"launches {launches['prep evaluate --synth']} (expected "
            f"{ {k: v for k, v in eval_want.items() if v} }: the validation "
            f"forward, the sample's forward, two iSTFT vocoder forwards), "
            f"{timings['evaluate_s']:.2f} s; {printed.getvalue().splitlines()[-1]!r}"
            f" on {card}")
        if launches["prep evaluate --synth"] != eval_want:
            raise RuntimeError("[prep evaluate] launches differ")
        if not (wav_lens[0] == wav_lens[1] > 0 and wav_lens[0] % hop == 0):
            raise RuntimeError(f"[prep evaluate] wavs {wav_lens}")
        if not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"[prep evaluate] losses {losses}")
        recording.close()
        check_recorded_inputs(seen, "prep kernels", card)
    return dict(launches=launches, timings=timings, features=dict(
        preprocess_yaml=card_yaml, train_yaml=train_yaml,
        step=PREP_STEPS, eval_yaml=eval_yaml))


def _kernel_group(name):
    """A device kernel's group in the GAN step's breakdown."""
    low = name.lower()
    if "multi_tensor" in low or "foreach" in low:
        return "optimizer (foreach AdamW)"
    if "fft" in low:
        return "cuFFT (STFT)"
    if any(k in low for k in ("conv", "cudnn", "xmma", "gemm", "implicit",
                              "wgrad", "dgrad", "winograd", "cutlass")):
        return "cuDNN convolutions and cuBLAS GEMMs"
    return "elementwise, reductions and copies"


def _merged_us(intervals):
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def vocoder_training(device, card, features, tmp):
    """Phase 15, vocoder training at full width on phase 13's features (the
    tracked clips preprocessed on the card, trimmed wavs kept): export_mels
    through its CLI at float32 and bfloat16, VOC_STEPS GAN steps through
    the train_vocoder CLI on the documented recipe, a resume under
    torch.profiler, the other generator families and modes briefly, two
    trainings from one seed, and synthesis from the trained vocoder, its
    lean export and phase 13's exported acoustic checkpoint.  Each driven
    path has the launch counts set to 0 just before and read just after.
    Raises on a failed gate -> {"launches": {path: counts}, "timings":
    {...}}."""
    import shutil

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from fastspeech2_tpu_torch.cli import (
        export_cli,
        export_mels_cli,
        train_vocoder_cli,
    )
    from fastspeech2_tpu_torch.configs.config import load_yaml_configs
    from fastspeech2_tpu_torch.models import transformer
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.models.hifigan import ResBlock
    from fastspeech2_tpu_torch.ops import cuda_ffn
    from fastspeech2_tpu_torch.ops.attention import multi_head_attention
    from fastspeech2_tpu_torch.synthesis.vocoder import get_vocoder
    from fastspeech2_tpu_torch.training import vocoder as voc

    pre_yaml, train_yaml = features["preprocess_yaml"], features["train_yaml"]
    with open(pre_yaml) as f:
        corpus = yaml.safe_load(f)["path"]["preprocessed_path"]
    launches, timings = {}, {}
    none = {k: 0 for k in launch_counts()}

    def synced():
        torch.cuda.synchronize()
        return time.perf_counter()

    # 1. export_mels through its CLI's main, teacher-forced on durations:
    #    each acoustic forward recorded with its launches, then run again
    #    with the plain K1/K2; bfloat16 first, so that mel_pred/ holds the
    #    float32 mels the training reads
    mel_dir, pred_dir = (os.path.join(corpus, d) for d in ("mel", "mel_pred"))
    for dtype in ("bfloat16", "float32"):
        calls = []
        inner = FastSpeech2.forward

        def forward(self, *args, **kwargs):
            before = launch_counts()
            out = inner(self, *args, **kwargs)
            after = launch_counts()
            calls.append(dict(model=self, args=args, kwargs=kwargs, out=out,
                              launches={k: after[k] - before[k]
                                        for k in after}))
            return out

        FastSpeech2.forward = forward
        printed = io.StringIO()
        zero_counts()
        t0 = synced()
        try:
            with contextlib.redirect_stdout(printed):
                written = export_mels_cli.main([
                    "-p", pre_yaml, "-m", f"{CONFIG}/model.yaml",
                    "-t", train_yaml, "--weights_npz", ACOUSTIC_NPZ,
                    "--teacher_force", "d", "--dtype", dtype])
        finally:
            FastSpeech2.forward = inner
        timings[f"export_mels_{dtype}_s"] = synced() - t0
        path = f"export_mels {dtype}"
        launches[path] = launch_counts()
        names = sorted(os.listdir(pred_dir))
        shapes_ok = all(
            np.load(os.path.join(pred_dir, n)).shape
            == np.load(os.path.join(mel_dir, n)).shape
            and np.load(os.path.join(pred_dir, n)).shape[1] == 80
            for n in names)
        per_forward = dict(none, **({"K1": 10, "K2": 10} if dtype == "float32"
                                    else {"K1_bf16": 10, "K2_bf16": 10}))
        mel_errs = []
        if dtype == "float32":
            saved = transformer.fused_attention, transformer.fused_conv_ffn
            transformer.fused_attention = multi_head_attention
            transformer.fused_conv_ffn = cuda_ffn.plain_conv_ffn
            try:
                with torch.inference_mode():
                    for c in calls:
                        plain = c["model"](*c["args"], **c["kwargs"])
                        mel_errs.append((c["out"].postnet_mel
                                         - plain.postnet_mel).abs().max()
                                        .item())
            finally:
                (transformer.fused_attention,
                 transformer.fused_conv_ffn) = saved
        finite = all(torch.isfinite(c["out"].postnet_mel).all()
                     for c in calls)
        say(f"[vocoder export_mels] python -m fastspeech2_tpu_torch.cli."
            f"export_mels_cli --teacher_force d --dtype {dtype} over "
            f"train.txt of the card's features: {written} mels written, "
            f"{len(names)} files in mel_pred/ of [mel_len, 80] each equal to "
            f"the ground-truth mel's shape: {shapes_ok}; {len(calls)} "
            f"forward(s) at (batch, frames) "
            f"{[tuple(c['out'].postnet_mel.shape[:2]) for c in calls]}, "
            f"launches per forward "
            f"{[{k: v for k, v in c['launches'].items() if v} for c in calls]}"
            + (f", each forward's mel against the same forward with the "
               f"plain K1/K2 max_abs_diff {[f'{e:.3e}' for e in mel_errs]} "
               f"(tolerance {MEL_ATOL:g})" if mel_errs else "")
            + f"; {timings[f'export_mels_{dtype}_s']:.2f} s for the CLI's "
            f"main (load, features, forwards, files) on {card}")
        if not (written == len(names) == 10 and shapes_ok and finite
                and calls and all(c["launches"] == per_forward
                                  for c in calls)):
            raise RuntimeError(f"[vocoder export_mels] {dtype}: {written} "
                               f"written, launches "
                               f"{[c['launches'] for c in calls]}")
        if not all(e <= MEL_ATOL for e in mel_errs):
            raise RuntimeError("[vocoder export_mels] the kernel forward's "
                               "mel disagrees with the plain versions'")
        del calls

    # 2. the GAN steps through the train_vocoder CLI's main; every step
    #    timed (device synchronised), its launches and losses recorded
    steps = []
    inner_make = voc.make_vocoder_train_step

    def make(*args, **kwargs):
        step = inner_make(*args, **kwargs)

        def recorded(state, *a, **kw):
            with record_function("vocoder_gan_step"):
                before, t0 = launch_counts(), synced()
                state, losses = step(state, *a, **kw)
                end = synced()
            after = launch_counts()
            steps.append(dict(ms=(end - t0) * 1e3, launches={
                k: after[k] - before[k] for k in after},
                losses={k: float(v) for k, v in losses.items()}))
            return state, losses
        return recorded

    def train(name, argv):
        """train_vocoder_cli.main(argv) with the counts set to 0 just
        before -> (its state, its printed lines, its steps)."""
        steps.clear()
        printed = io.StringIO()
        voc.make_vocoder_train_step = make
        zero_counts()
        t0 = synced()
        try:
            with contextlib.redirect_stdout(printed):
                state = train_vocoder_cli.main(argv)
        finally:
            voc.make_vocoder_train_step = inner_make
        timings[f"{name}_s"] = synced() - t0
        launches[f"vocoder {name}"] = launch_counts()
        lines = printed.getvalue().splitlines()
        recorded = list(steps)
        bad = [r for r in recorded if r["launches"] != none
               or not all(map(math.isfinite, r["losses"].values()))]
        if not recorded or bad:
            raise RuntimeError(f"[vocoder {name}] steps with a kernel "
                               f"launch or a loss not finite: {bad[:3]}")
        return state, lines, recorded

    out_dir = os.path.join(tmp, "vocoder")
    recipe = ["--finetune_from", corpus, "--mel_source", "mixed",
              "--config", VOC_CONFIG, "--init_gen_npz", VOCODER_NPZ,
              "--mel_weight", str(VOC_MEL_WEIGHT), "--log_step", "1",
              "--batch_size", str(VOC_BATCH),
              "--segment_size", str(VOC_SEGMENT)]
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    state, lines, main_steps = train("train", recipe + [
        "--out_dir", out_dir, "--total_steps", str(VOC_STEPS),
        "--save_step", str(VOC_STEPS)])
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_gen = sum(p.numel() for p in state.gen.parameters())
    n_disc = sum(p.numel() for p in state.disc.parameters())
    widths = (state.gen.conv_pre.out_channels,
              [len(d.convs) for d in state.disc.mpd.discriminators],
              len(state.disc.msd.discriminators))
    del state
    log_lines = [ln for ln in lines if ln.startswith("Vocoder step")]
    timings["step_ms"] = statistics.median(r["ms"] for r in main_steps[1:])
    first, last = main_steps[0]["losses"], main_steps[-1]["losses"]
    say(f"[vocoder train] python -m fastspeech2_tpu_torch.cli."
        f"train_vocoder_cli --finetune_from <card features> --mel_source "
        f"mixed --config {VOC_CONFIG} --init_gen_npz {VOCODER_NPZ} "
        f"--mel_weight {VOC_MEL_WEIGHT} (batch {VOC_BATCH} x {VOC_SEGMENT} "
        f"samples, C8C8I "
        f"conv_pre {widths[0]} channels, {n_gen} generator and {n_disc} "
        f"discriminator parameters, MPD periods 2-11 with "
        f"{widths[1][0]}-conv stacks, MSD {widths[2]} scales): "
        f"{len(main_steps)} steps in {timings['train_s']:.2f} s, median "
        f"{timings['step_ms']:.2f} ms per GAN step over steps "
        f"2-{len(main_steps)} (host clock, device synchronised; min "
        f"{min(r['ms'] for r in main_steps[1:]):.2f}, first step "
        f"{main_steps[0]['ms']:.2f}); peak device memory {peak_gib:.2f} GiB "
        f"({peak_gib - base_gib:.2f} above the {base_gib:.2f} held before); "
        f"losses at step 1 "
        f"{ {k: round(v, 4) for k, v in first.items()} }, at step "
        f"{len(main_steps)} {({k: round(v, 4) for k, v in last.items()})}; "
        f"kernel launches per step {main_steps[0]['launches']} (K4 is "
        f"inference-only: the trainer's ResBlocks are plain); "
        f"{len(log_lines)} log lines, the last {log_lines[-1]!r} on {card}")
    if len(main_steps) != VOC_STEPS or len(log_lines) != VOC_STEPS:
        raise RuntimeError(f"[vocoder train] {len(main_steps)} steps, "
                           f"{len(log_lines)} log lines")
    if not os.path.exists(os.path.join(out_dir, f"{VOC_STEPS}.pth.tar")):
        raise RuntimeError("[vocoder train] no checkpoint written")
    timings["peak_gib"] = peak_gib

    # ... resumed for VOC_RESUME_STEPS more steps inside a torch.profiler
    #     window: each kernel's device time by group, the device's busy
    #     share within the steps and over the window
    total = VOC_STEPS + VOC_RESUME_STEPS
    trace = os.path.join(tmp, "vocoder_trace.json")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, lines, resumed = train("resume", recipe + [
            "--out_dir", out_dir, "--total_steps", str(total),
            "--save_step", str(total)])
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    os.remove(trace)
    resumed_step = state.step
    del state
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("name") == "vocoder_gan_step"
                   and e.get("cat") == "user_annotation")
    kernel_events = [(e["ts"], e["ts"] + e["dur"], e.get("name", ""),
                      e.get("args", {}).get("stream"))
                     for e in events if e.get("cat") == "kernel"]
    kernels = sorted({k[:3] for k in kernel_events})
    # kernels per stream inside the steps: (launches, ms per step)
    by_stream = {}

    def inside(a):
        return any(s <= a <= e for s, e in spans)

    in_steps = [k for k in kernels if inside(k[0])]
    for a, b, _, stream in kernel_events:
        if inside(a):
            v = by_stream.setdefault(str(stream), [0, 0.0])
            v[0] += 1
            v[1] += (b - a) / 1e3 / max(len(spans), 1)
    groups = {}
    for a, b, name in in_steps:
        g = groups.setdefault(_kernel_group(name), [0, 0.0])
        g[0] += 1
        g[1] += (b - a) / 1e3 / max(len(spans), 1)
    step_us = sum(e - s for s, e in spans)
    busy_steps = _merged_us([(a, b) for a, b, _ in in_steps]) / max(
        step_us, 1e-9)
    window_us = (spans[-1][1] - spans[0][0]) if spans else 0.0
    busy_window = _merged_us([(a, b) for a, b, _ in kernels
                              if spans and spans[0][0] <= a <= spans[-1][1]]
                             ) / max(window_us, 1e-9)
    kernel_ms = sum(v[1] for v in groups.values())
    union_ms = _merged_us([(a, b) for a, b, _ in in_steps]) / 1e3 / max(
        len(spans), 1)
    timings.update(resume_step_ms=statistics.median(
        r["ms"] for r in resumed), profiled_kernel_ms=kernel_ms,
        profiled_union_ms=union_ms, busy_share=busy_steps, busy_share_window=busy_window,
        kernel_groups={k: dict(launches=v[0] / max(len(spans), 1), ms=v[1])
                       for k, v in groups.items()})
    say(f"[vocoder resume] train_vocoder_cli to --total_steps {total} on "
        f"the same --out_dir: {lines[0]!r}, trained to step {resumed_step} "
        f"({len(resumed)} steps, median {timings['resume_step_ms']:.2f} ms "
        f"each under torch.profiler); per GAN step in that window, "
        f"{kernel_ms:.2f} ms of device kernels summed, {union_ms:.2f} ms "
        f"of device time covered by a kernel ({len(kernel_events)} kernel "
        f"events, {len(kernel_events) - len(kernels)} duplicates dropped; "
        f"per stream (launches, ms) "
        f"{({k: (v[0], round(v[1], 3)) for k, v in sorted(by_stream.items(), key=lambda kv: -kv[1][1])})}"
        f"), by group (launches, ms) "
        f"{({k: (round(v['launches'], 1), round(v['ms'], 3)) for k, v in timings['kernel_groups'].items()})}; "
        f"device busy {100 * busy_steps:.1f}% of the steps' time "
        f"({len(spans)} steps, {step_us / 1e3:.2f} ms), "
        f"{100 * busy_window:.1f}% from the first step's start to the "
        f"last's end (the loop's sampling and logging between steps "
        f"included) on {card}")
    if not (lines[0] == f"Resumed vocoder training from step {VOC_STEPS}"
            and resumed_step == total and len(resumed) == VOC_RESUME_STEPS
            and len(spans) == VOC_RESUME_STEPS and in_steps):
        raise RuntimeError(f"[vocoder resume] {lines[:2]}, step "
                           f"{resumed_step}, {len(spans)} traced steps")

    # 3. the other generator families and modes, briefly
    brief = {
        "parity": ["--config", VOC_PARITY_CONFIG, "--mel_source", "mixed"],
        "melgan": ["--config", VOC_MELGAN_CONFIG, "--mel_source", "mixed",
                   "--init_gen_npz", MELGAN_NPZ],
        "gt_wav augmented": ["--config", VOC_CONFIG, "--mel_source",
                             "gt_wav", "--aug_gain_db", "6", "--aug_speed",
                             "0.9,1.1"],
        "scan": ["--config", VOC_CONFIG, "--mel_source", "mixed",
                 "--scan_step", str(VOC_SCAN_STEP)],
    }
    for name, extra in brief.items():
        n = VOC_SCAN_TOTAL if name == "scan" else VOC_BRIEF_STEPS
        log_step = VOC_SCAN_STEP if name == "scan" else 1
        run_dir = os.path.join(tmp, f"vocoder_{name.split()[0]}")
        state, lines, run = train(name, [
            "--finetune_from", corpus, "--out_dir", run_dir,
            "--total_steps", str(n), "--log_step", str(log_step),
            "--save_step", str(n), "--batch_size", str(VOC_BATCH),
            "--segment_size", str(VOC_SEGMENT)] + extra)
        kind = type(state.gen).__name__
        del state
        shutil.rmtree(run_dir)
        logged = [ln for ln in lines if ln.startswith("Vocoder step")]
        say(f"[vocoder {name}] {' '.join(extra)}: {kind}, {len(run)} steps, "
            f"median {statistics.median(r['ms'] for r in run):.2f} ms per "
            f"step; {len(logged)} log lines, the last {logged[-1]!r}"
            + (f"; {lines[0]!r}" if name == "scan" else "")
            + f"; kernel launches {launches[f'vocoder {name}']} on {card}")
        if len(run) != n or len(logged) != n // log_step or (
                name == "scan" and not lines[0].startswith(
                    "vocoder scan mode:")):
            raise RuntimeError(f"[vocoder {name}] {len(run)} steps, lines "
                               f"{lines[:3]}")

    # 4. two trainings of VOC_REPRO_STEPS steps from one seed
    params = []
    for run in range(2):
        run_dir = os.path.join(tmp, f"vocoder_repro{run}")
        state, _, _ = train("repro", recipe + [
            "--out_dir", run_dir, "--total_steps", str(VOC_REPRO_STEPS),
            "--save_step", str(VOC_REPRO_STEPS)])
        params.append({f"{net}.{k}": v.detach().clone() for net, module in
                       (("gen", state.gen), ("disc", state.disc))
                       for k, v in module.state_dict().items()})
        del state
        shutil.rmtree(run_dir)
    diffs = {k: (params[0][k] - params[1][k]).abs().max().item()
             for k in params[0]}
    repro_diff = max(diffs.values())
    say(f"[vocoder repro] {VOC_REPRO_STEPS} GAN steps twice from one seed "
        f"through train_vocoder_cli (cuDNN deterministic, TF32 off): max "
        f"|parameter difference| {repro_diff:.3e} over {len(diffs)} tensors "
        f"of both networks ({sum(v > 0 for v in diffs.values())} differ)")
    if repro_diff != 0.0:
        raise RuntimeError("[vocoder repro] two trainings from one seed "
                           "differ")
    del params

    # 5. synthesis from the trained vocoder through the synthesize CLI, its
    #    lean export, and phase 13's acoustic checkpoint exported
    ckpt = os.path.join(out_dir, f"{total}.pth.tar")
    lean = os.path.join(tmp, "generator_lean.pth.tar")
    acoustic = os.path.join(tmp, "acoustic_export.pth.tar")
    result = os.path.join(tmp, "vocoder_result")

    def synth(vocoder_ckpt, acoustic_args, pre=f"{CONFIG}/preprocess.yaml",
              train=f"{CONFIG}/train.yaml"):
        return drive_cli(["--mode", "single", "--text", README_SENTENCE,
                          "--vocoder_ckpt", vocoder_ckpt, "-p", pre,
                          "-m", f"{CONFIG}/model.yaml", "-t", train,
                          "--result_path", result] + acoustic_args)

    (wavs, out, _), synth_launches, _, _, synth_s = synth(
        ckpt, ["--weights_npz", ACOUSTIC_NPZ])
    launches["vocoder synthesis"] = synth_launches
    preprocess_config, model_config, _ = load_yaml_configs(
        f"{CONFIG}/preprocess.yaml", f"{CONFIG}/model.yaml",
        f"{CONFIG}/train.yaml")
    vocoder = get_vocoder(model_config, preprocess_config, ckpt, device)
    blocks = [m for m in vocoder.modules() if isinstance(m, ResBlock)]
    with torch.inference_mode():
        fused = vocoder(out.postnet_mel.float())
        for m in blocks:
            m.fused = False
        plain = vocoder(out.postnet_mel.float())
    wav_err = (fused - plain).abs().max().item()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        export_cli.main(["--vocoder_ckpt", ckpt, "-o", lean])
        export_cli.main(["--restore_step", str(features["step"]), "-p",
                         pre_yaml, "-m", f"{CONFIG}/model.yaml", "-t",
                         train_yaml, "-o", acoustic])
    (lean_wavs, _, _), _, _, _, _ = synth(lean,
                                          ["--weights_npz", ACOUSTIC_NPZ])
    (exp_wavs, _, _), exp_launches, _, _, _ = synth(
        ckpt, ["--torch_ckpt", acoustic], pre=pre_yaml, train=train_yaml)
    (ref_wavs, _, _), _, _, _, _ = synth(
        ckpt, ["--restore_step", str(features["step"])], pre=pre_yaml,
        train=train_yaml)
    sizes = {os.path.basename(p): os.path.getsize(p) / 1e6
             for p in (ckpt, lean, acoustic)}
    say(f"[vocoder synthesis] the README sentence through the synthesize "
        f"CLI with --vocoder_ckpt <out_dir>/{total}.pth.tar: {len(wavs[0])} "
        f"samples, launches {synth_launches}, {synth_s:.2f} s; the trained "
        f"vocoder's wav with K4 against its plain ResBlocks "
        f"max_abs_diff={wav_err:.3e} (tolerance {WAV_ATOL:g}); "
        f"{printed.getvalue().splitlines()[0]!r}; the lean export's wav "
        f"equal bit for bit: {np.array_equal(lean_wavs[0], wavs[0])}; "
        f"export_cli --restore_step {features['step']} on phase 13's "
        f"acoustic checkpoint read through --torch_ckpt: wav equal bit for "
        f"bit to --restore_step's: {np.array_equal(exp_wavs[0], ref_wavs[0])} "
        f"(launches {exp_launches}); file sizes (MB) "
        f"{({k: round(v, 1) for k, v in sizes.items()})} on {card}")
    if synth_launches != dict(none, K1=10, K2=10, K4=6):
        raise RuntimeError(f"[vocoder synthesis] launches {synth_launches}, "
                           "expected 10 K1 + 10 K2 + 6 K4")
    if not (wav_err <= WAV_ATOL and torch.isfinite(fused).all()
            and np.abs(wavs[0].astype(np.int32)).max() > 0):
        raise RuntimeError("[vocoder synthesis] the trained vocoder's K4 "
                           "wav disagrees with its plain ResBlocks")
    if not np.array_equal(lean_wavs[0], wavs[0]):
        raise RuntimeError("[vocoder synthesis] the lean export's wav "
                           "differs from the train state's")
    if not (np.array_equal(exp_wavs[0], ref_wavs[0])
            and exp_launches["K4"] == 6):
        raise RuntimeError("[vocoder synthesis] the exported acoustic "
                           "checkpoint's wav differs")
    timings["synthesis_s"] = synth_s
    return dict(launches=launches, timings=timings)


def batch_tail_frames(model, vocoder):
    """The frames at the end of an utterance whose samples may depend on its
    batch-mates in a coalesced dispatch: the PostNet's frame mask is at the
    batch's largest mel_len (models/fastspeech2.py), so its output moves
    within its receptive radius (n_conv x (k - 1) / 2 frames) of the row's
    end, and the vocoder, which runs on the padded frames, spreads that by
    its own radius (conv_pre, each upsampling stage's transposed conv and
    widest ResBlock, conv_post and the iSTFT's overlap, at their rates)."""
    postnet = model.postnet.convolutions
    radius = len(postnet) * (postnet[0][0].conv.kernel_size[0] - 1) / 2
    radius += (vocoder.conv_pre.kernel_size[0] - 1) / 2
    rate = 1
    n = len(vocoder.resblocks) // len(vocoder.ups)
    for i, up in enumerate(vocoder.ups):
        radius += math.ceil(up.kernel_size[0] / up.stride[0]) / rate
        rate *= up.stride[0]
        radius += max(
            sum((block.convs1[0].kernel_size[0] - 1) // 2 * (d + 1)
                for d in block.dilations)
            for block in vocoder.resblocks[i * n:(i + 1) * n]) / rate
    radius += (vocoder.conv_post.kernel_size[0] - 1) / 2 / rate
    if hasattr(vocoder, "n_fft"):
        radius += vocoder.n_fft / vocoder.hop / rate
    return math.ceil(radius)


def trace_kernels(fn, tmp, span="window"):
    """fn() inside a torch.profiler window with a ``span`` annotation around
    it -> (fn's result, [(start us, end us, kernel name)] of every device
    kernel, (start, end) of the span)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    trace = os.path.join(tmp, f"{span}_trace.json")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a first kernel in the window before fn: a trace that dropped
        # the first kernels of a window (a replay's encoder, phase 16 of
        # a run) drops this one instead; it is left out below
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with record_function(span):
            result = fn()
            torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    os.remove(trace)
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e.get("name", ""))
                     for e in events if e.get("cat") == "kernel"
                     and "spin_kernel" not in e.get("name", ""))
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == span and e.get("cat") == "user_annotation"]
    return result, kernels, (spans[0] if spans else None)


# the kernel-name prefixes of K1's, K2's and K4's launches (K1: the
# attention and its key-split combine; K2: its two convs and LayerNorm;
# K4: the one-launch unit and the two-launch conv)
DISPATCH_KERNELS = {"K1": "mha_fwd_", "K2": "ffn_", "K4": "resblock_"}


def kernel_names_by_id(kernels):
    """-> {K1|K2|K4: {kernel function: launches}} of a profiler window."""
    found = {}
    for _, _, name in kernels:
        fn = re.search(r"(\w+_kernel)\b", name)
        kid = next((k for k, prefix in DISPATCH_KERNELS.items()
                    if fn and fn.group(1).startswith(prefix)), None)
        if kid:
            by = found.setdefault(kid, {})
            by[fn.group(1)] = by.get(fn.group(1), 0) + 1
    return found


def serving(device, card, tmp):
    """Phase 16, serving: the serve CLI's build_server on the tracked
    weights (max batch 16), warmup(grid="top") (one CUDA graph, batch 16 x
    text 128), the graph against the eager dispatch (bitwise) and the plain
    versions (WAV_ATOL) on a [16 x 128] batch, the kernels inside a replay
    by the profiler (the constants it reads evicted from their caches
    first), HTTP requests one at a time (each wav bitwise the solo
    dispatch's) and a burst of concurrent ones (coalesced; each wav the
    solo one's outside the batch-mates' tail) with a stream and a long text
    beside it, a burst under the profiler (the device's idle share), 401,
    413, 429, then grid="background" during a burst (20 graphs) and
    grid="full"; the dispatch timed as a replay
    and eagerly, and K1, K2 and K4 at the new shapes against their plain
    versions.  Raises on a failed gate -> {"launches": {"serving": counts},
    "timings": {...}, "per_shape": {kernel: [rows]}}."""
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch
    import torch.nn.functional as F

    from fastspeech2_tpu_torch.cli import serve_cli
    from fastspeech2_tpu_torch.cli.synthesize_cli import load_metadata_rows
    from fastspeech2_tpu_torch.models import hifigan_istft, transformer
    from fastspeech2_tpu_torch.models.hifigan import ResBlock
    from fastspeech2_tpu_torch.ops import (
        cuda_attention,
        cuda_ffn,
        cuda_resblock,
        positional,
    )
    from fastspeech2_tpu_torch.ops.attention import multi_head_attention
    from fastspeech2_tpu_torch.text import text_to_sequence
    from fastspeech2_tpu_torch.tools.kernel_bounds import (
        attention_bound_ms,
        ffn_bound_ms,
        resblock_bound_ms,
    )

    token = "chip-smoke-token"
    t0 = time.perf_counter()
    server = serve_cli.build_server(serve_cli.build_parser().parse_args([
        "-p", f"{CONFIG}/preprocess.yaml", "-m", f"{CONFIG}/model.yaml",
        "-t", f"{CONFIG}/train.yaml", "--weights_npz", ACOUSTIC_NPZ,
        "--vocoder_ckpt", VOCODER_NPZ, "--port", "0", "--max_batch_size",
        "16", "--auth_token", token]))
    build_s = time.perf_counter() - t0
    batcher, syn = server.batcher, server.batcher.synthesizer
    graphs, model, vocoder = syn.graphs, syn.model, syn.vocoder
    pp = syn.preprocess_config["preprocessing"]
    hop = pp["stft"]["hop_length"]
    timings = {"build_s": build_s}
    try:
        if graphs is None or not syn.fused:
            raise RuntimeError("[serve] the synthesizer has no CUDA graphs")
        logs = []
        t0 = time.perf_counter()
        batcher.warmup(grid="top", log=logs.append)
        timings["warmup_top_s"] = time.perf_counter() - t0
        top = graphs.graphs.get((16, 128))
        pool = graphs.pool_bytes()
        timings["pool_top_mb"] = None if pool is None else pool / 2**20
        say(f"[serve] build_server {build_s:.2f} s; warmup(grid=top) "
            f"{timings['warmup_top_s']:.2f} s ({graphs.capture_seconds:.2f} s"
            f" in the warm-up run and the capture); graphs "
            f"{sorted(graphs.graphs)}; launches captured in the top graph "
            f"{top.launches if top else None}; the graphs' shared pool "
            f"{pool} bytes; {logs[0]!r}")
        per_replay = {"K1": 10, "K1_bf16": 0, "K2": 10, "K2_bf16": 0,
                      "K4": 6}
        if sorted(graphs.graphs) != [(16, 128)] or top.launches != \
                per_replay or syn._warm != {(16, 128)}:
            raise RuntimeError("[serve] warmup(grid='top') did not capture "
                               "one [16 x 128] graph of 10 K1 + 10 K2 + 6 "
                               "K4")

        # the [16 x 128] batch: the 10 train.txt rows' phones + the README
        # sentence's, through the graph, eagerly and with the plain versions
        _, _, phones = load_metadata_rows(syn.preprocess_config,
                                          BATCH_SOURCE)
        cleaners = pp["text"]["text_cleaners"]
        ids = [np.asarray(text_to_sequence(t, cleaners), np.int64)
               for t in phones] + [syn.text_to_ids(README_SENTENCE)[0]]
        speakers, texts, src_lens = syn._pack_batch(ids, [0] * len(ids),
                                                    snap=True)
        if tuple(texts.shape) != (16, 128):
            raise RuntimeError(f"[serve] the batch packed to "
                               f"{tuple(texts.shape)}, not [16, 128]")
        controls = (1.0, 1.0, 1.0, 0.0, 0.0)
        # the caches of the constants the graph reads (position tables,
        # the iSTFT's) let go of them, and their memory is handed out
        # again, filled with NaN: the graph keeps what it reads
        kept = top.constants
        sizes = [t.numel() for c in kept
                 for t in (c if isinstance(c, tuple) else (c,))]
        for cache in (positional._device_table,
                      hifigan_istft._istft_constants,
                      hifigan_istft._window_sum_square):
            cache.cache_clear()
        junk = []
        for stream in (graphs.stream, torch.cuda.current_stream(device)):
            with torch.cuda.stream(stream):
                junk += [torch.full((n,), float("nan"), device=device)
                         for n in sizes for _ in range(4)]
        wav_g, out_g = graphs.run(speakers, texts, src_lens, controls)
        del junk
        say(f"[serve] the top graph keeps the {len(sizes)} cached constants "
            f"its capture read; their caches cleared and their memory "
            f"handed out again (NaN) before the replay below")
        wav_e, out_e = syn.fused_forward(speakers, texts, src_lens, controls)
        saved = transformer.fused_attention, transformer.fused_conv_ffn
        resblocks = [m for m in vocoder.modules() if isinstance(m, ResBlock)]
        transformer.fused_attention = multi_head_attention
        transformer.fused_conv_ffn = cuda_ffn.plain_conv_ffn
        for m in resblocks:
            m.fused = False
        try:
            wav_p, out_p = syn.fused_forward(speakers, texts, src_lens,
                                             controls)
        finally:
            transformer.fused_attention, transformer.fused_conv_ffn = saved
            for m in resblocks:
                m.fused = True
        eager_equal = torch.equal(wav_g, wav_e) and all(
            torch.equal(a, b) for a, b in zip(out_g, out_e))
        plain_err = (wav_g - wav_p).abs().max().item()
        mel_len = out_g.mel_len[: len(ids)].tolist()
        say(f"[serve] [16 x 128] dispatch of the {len(phones)} {BATCH_SOURCE} "
            f"rows + the README sentence (mel_len {mel_len}): graph replay vs "
            f"eager kernel dispatch bitwise equal (wav and every output): "
            f"{eager_equal}; vs the plain versions (plain K1, K2, ResBlocks): "
            f"durations equal "
            f"{torch.equal(out_g.duration_rounded, out_p.duration_rounded)},"
            f" wav max_abs_diff {plain_err:.3e} (tolerance {WAV_ATOL:g}; "
            f"largest |sample| {wav_p.abs().max().item():.3e}); finite "
            f"{bool(torch.isfinite(wav_g).all())}")
        if not eager_equal:
            raise RuntimeError("[serve] the graph's dispatch is not the eager "
                               "dispatch bit for bit")
        if not torch.equal(out_g.duration_rounded, out_p.duration_rounded):
            raise RuntimeError("[serve] plain versions predict other "
                               "durations")
        if not plain_err <= WAV_ATOL or not torch.isfinite(wav_g).all():
            raise RuntimeError("[serve] the graph's wavs disagree with the "
                               "plain versions'")

        # the kernels inside one replay and one eager dispatch, by the
        # profiler; both traced again, up to 3 times, while their K1, K2
        # and K4 kernels differ: a late window can lose a dispatch's first
        # kernels (PERF.md §7), while a replay runs the same kernels every
        # time.  The kernels each pair of traces held is reported
        attempts = []
        for _ in range(3):
            (_, kernels, _) = trace_kernels(
                lambda: graphs.run(speakers, texts, src_lens, controls), tmp,
                "replay")
            (_, eager_kernels, _) = trace_kernels(
                lambda: syn.fused_forward(speakers, texts, src_lens,
                                          controls), tmp, "eager")
            in_replay, in_eager = (kernel_names_by_id(k)
                                   for k in (kernels, eager_kernels))
            attempts.append((len(kernels), len(eager_kernels)))
            if in_replay == in_eager:
                break
        groups = {}
        for a, b, name in kernels:
            fn = re.search(r"(\w+_kernel)\b", name)
            kid = next((k for k, prefix in DISPATCH_KERNELS.items()
                        if fn and fn.group(1).startswith(prefix)),
                       _kernel_group(name))
            groups[kid] = groups.get(kid, 0.0) + (b - a) / 1e3
        timings["replay_groups_ms"] = groups
        timings["replay_busy_ms"] = _merged_us(
            [(a, b) for a, b, _ in kernels]) / 1e3
        say(f"[serve] torch.profiler around one replay: {len(kernels)} "
            f"device kernels, {timings['replay_busy_ms']:.3f} ms covered; "
            f"device ms by group { {k: round(v, 3) for k, v in groups.items()} }"
            f"; K1/K2/K4 kernels by name {in_replay} (the eager dispatch: "
            f"{in_eager}, {len(eager_kernels)} kernels; (replay, eager) "
            f"kernels in each pair of traces {attempts})")
        if sorted(in_replay) != ["K1", "K2", "K4"] or in_replay != in_eager:
            raise RuntimeError("[serve] the replay does not run the eager "
                               "dispatch's K1, K2 and K4 kernels")

        # one dispatch timed: a replay against the eager dispatch
        timings["replay_ms"] = cuda_time_ms(
            lambda: graphs.run(speakers, texts, src_lens, controls),
            iters=10, warmup=2)
        timings["eager_ms"] = cuda_time_ms(
            lambda: syn.fused_forward(speakers, texts, src_lens, controls),
            iters=10, warmup=2)
        say(f"[serve] one [16 x 128] dispatch (CUDA events, 10 after 2; the "
            f"copies in and out included): replay "
            f"{timings['replay_ms']:.3f} ms, eager "
            f"{timings['eager_ms']:.3f} ms on {card}")
        del wav_e, out_e, wav_p, out_p

        # HTTP: texts whose phones fit the top shape
        with open(BATCH_SOURCE) as f:
            raw = [line.rstrip("\n").split("|")[3] for line in f]
        pool_texts = [t for t in raw + [README_SENTENCE] + LONG_TEXT.split(
            ". ") if len(syn.text_to_ids(t)[0]) <= 128]
        solo = {t: syn.synthesize([t])[0][0] for t in pool_texts}
        tail = batch_tail_frames(model, vocoder)
        server.start()
        url = f"http://127.0.0.1:{server.port}"

        def post(payload, path="/synthesize", auth=True, data=None):
            headers = {"Content-Type": "application/json"}
            if auth:
                headers["Authorization"] = f"Bearer {token}"
            req = urllib.request.Request(
                url + path, headers=headers,
                data=data if data is not None else json.dumps(
                    payload).encode())
            try:
                with urllib.request.urlopen(req, timeout=300) as r:
                    return r.status, dict(r.headers), r.read()
            except urllib.error.HTTPError as exc:
                return exc.code, dict(exc.headers), exc.read()

        def pcm(body):
            if body[:4] != b"RIFF":
                raise RuntimeError("[serve] not a RIFF wav")
            return np.frombuffer(body[44:], np.int16)

        # the references of the stream and the long text, made before the
        # counts are set to 0
        stream_text = "They bought their offices. One another!"
        stream_parts = [syn.synthesize([t])[0][0]
                        for t in stream_text.split(" One")[:1]
                        + ["One another!"]]
        long_want, chunks = syn.synthesize_long(LONG_TEXT)

        graphs.reset_replays()
        zero_counts()
        stats0 = batcher.stats()
        # one at a time: each wav the solo dispatch's, bit for bit
        lat = []
        for i in range(12):
            text = pool_texts[i % len(pool_texts)]
            t0 = time.perf_counter()
            code, _, body = post({"text": text, "long": False})
            lat.append((time.perf_counter() - t0) * 1e3)
            if code != 200 or not np.array_equal(pcm(body), solo[text]):
                raise RuntimeError(f"[serve] request {i} ({text!r}): status "
                                   f"{code}, not the solo dispatch's wav")
        timings["c1_p50_ms"] = float(np.percentile(lat, 50))
        timings["c1_max_ms"] = max(lat)
        stats1 = batcher.stats()

        # a burst of 32 concurrent requests, a stream and a long text
        results, errors = {}, []

        def call(i):
            text = pool_texts[i % len(pool_texts)]
            t1 = time.perf_counter()
            code, _, body = post({"text": text, "long": False})
            results[i] = (text, code, body, time.perf_counter() - t1)

        def side(kind):
            try:
                if kind == "stream":
                    results[kind] = post({"text": stream_text},
                                         "/synthesize_stream")
                else:
                    results[kind] = post({"text": LONG_TEXT, "long": True})
            except Exception as exc:   # reported below
                errors.append((kind, exc))

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(32)]
        threads += [threading.Thread(target=side, args=(k,))
                    for k in ("stream", "long")]
        # host time in the frontend and in the fused dispatches (the
        # dispatcher thread runs both, one batch after another)
        spent = {"text_to_ids": [0.0, 0], "synthesize_ids": [0.0, 0]}
        spent_lock = threading.Lock()

        def timed(name):
            inner = getattr(syn, name)

            def fn(*args, **kwargs):
                t1 = time.perf_counter()
                try:
                    return inner(*args, **kwargs)
                finally:
                    with spent_lock:
                        spent[name][0] += time.perf_counter() - t1
                        spent[name][1] += 1
            return fn

        for name in spent:
            setattr(syn, name, timed(name))
        t0 = time.perf_counter()
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
        finally:
            for name in spent:
                delattr(syn, name)
        burst_s = time.perf_counter() - t0
        timings["burst_host_s"] = {k: v[0] for k, v in spent.items()}
        timings["burst_host_calls"] = {k: v[1] for k, v in spent.items()}
        stats2 = batcher.stats()
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"[serve] burst errors {errors}")
        n_req = stats2["requests"] - stats1["requests"]
        n_bat = stats2["batches"] - stats1["batches"]
        mismatched = []
        for i in range(32):
            text, code, body, _ = results[i]
            got, want = pcm(body), solo[text]
            head = len(want) - tail * hop
            if code != 200 or len(got) != len(want) or not np.array_equal(
                    got[:head], want[:head]):
                mismatched.append(i)
        code, headers, body = results["stream"]
        stream = np.frombuffer(body, np.int16)
        pause = int(pp["audio"]["sampling_rate"] * 0.12)
        parts = [len(p) for p in stream_parts]
        stream_ok = (code == 200 and headers.get("Content-Type", "")
                     .startswith("audio/L16") and len(stream) == sum(parts)
                     + pause and np.array_equal(
                         stream[:parts[0] - tail * hop],
                         stream_parts[0][:parts[0] - tail * hop]))
        code_l, _, body_l = results["long"]
        long_ok = code_l == 200 and np.array_equal(pcm(body_l), long_want)
        lat32 = [results[i][3] * 1e3 for i in range(32)]
        timings.update(
            burst_s=burst_s, burst_utt_per_s=32 / burst_s,
            burst_mean_batch=n_req / max(n_bat, 1),
            burst_p50_ms=float(np.percentile(lat32, 50)),
            burst_max_ms=max(lat32))
        say(f"[serve] HTTP one at a time, {stats1['requests'] - stats0['requests']}"
            f" requests ({len(pool_texts)} texts): each wav the solo "
            f"dispatch's bit for bit; latency p50 {timings['c1_p50_ms']:.2f} "
            f"ms, max {timings['c1_max_ms']:.2f} ms (host clock, POST to the "
            f"last byte, frontend included); burst of 32 concurrent + a "
            f"stream + a long text: {burst_s:.3f} s, "
            f"{timings['burst_utt_per_s']:.2f} utterances/s, {n_req} "
            f"requests in {n_bat} dispatches (mean_batch "
            f"{timings['burst_mean_batch']:.2f}), latency p50 "
            f"{timings['burst_p50_ms']:.2f} ms, max "
            f"{timings['burst_max_ms']:.2f} ms (too few requests for a tail "
            f"percentile: tools/serve_bench.py); host seconds in the "
            f"frontend (text_to_ids, {spent['text_to_ids'][1]} calls) "
            f"{spent['text_to_ids'][0]:.3f} and in the fused dispatches "
            f"(synthesize_ids, {spent['synthesize_ids'][1]} calls, the copy "
            f"to the host and the int16 trim included) "
            f"{spent['synthesize_ids'][0]:.3f}; wavs mel_len*hop long and "
            f"the solo wav's outside the last {tail} frames "
            f"({tail * hop} samples: the PostNet's and the vocoder's "
            f"receptive radius): {32 - len(mismatched)} of 32; stream "
            f"{len(stream)} samples = {parts} + a {pause}-sample pause: "
            f"{stream_ok}; long text ({len(chunks)} sentences) the solo "
            f"synthesize_long's bit for bit: {long_ok} on {card}")
        if mismatched or not stream_ok or not long_ok:
            raise RuntimeError(f"[serve] burst wavs {mismatched} differ from "
                               f"solo; stream {stream_ok}; long {long_ok}")
        if not timings["burst_mean_batch"] > 1:
            raise RuntimeError("[serve] the burst was not coalesced")

        # a second burst under the profiler: the device's idle share
        def burst():
            ts = [threading.Thread(target=call, args=(i,))
                  for i in range(32)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(300)

        _, kernels, span = trace_kernels(burst, tmp, "serving_burst")
        inside = [(a, b) for a, b, _ in kernels
                  if span and span[0] <= a <= span[1]]
        busy = _merged_us(inside) / max(span[1] - span[0], 1.0)
        timings["burst_busy"] = busy
        replays = graphs.replays()
        dispatch = {k: v for k, v in graphs.launches().items()}
        eager = launch_counts()
        launches = {k: eager[k] + dispatch.get(k, 0) for k in eager}
        say(f"[serve] the second burst under torch.profiler: "
            f"{(span[1] - span[0]) / 1e3:.2f} ms, {len(inside)} kernels, "
            f"device busy {busy:.1%}, idle {1 - busy:.1%}; launches on the "
            f"serving path (both bursts and the requests before): {replays}"
            f" replays x {per_replay} = {dispatch}, eager (re-dispatches) "
            f"{eager}")
        if any(eager[k] for k in eager):
            raise RuntimeError("[serve] the steady path launched kernels "
                               "outside the graphs")
        if any(dispatch[k] != per_replay[k] * replays for k in per_replay) \
                or not replays:
            raise RuntimeError("[serve] the replays' launches are not 10 K1 "
                               "+ 10 K2 + 6 K4 each")

        # 401, 413 and 429
        c401 = post({"text": "hello"}, auth=False)[0]
        c413 = post(None, data=json.dumps({"text": "x" * 70000}).encode())[0]
        batcher.max_pending = 2
        shed = []

        def shed_call(i):
            shed.append(post({"text": pool_texts[i % len(pool_texts)],
                              "long": False})[:2])

        ts = [threading.Thread(target=shed_call, args=(i,))
              for i in range(12)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(300)
        batcher.max_pending = 256
        n429 = [h.get("Retry-After") for c, h in shed if c == 429]
        n200 = sum(c == 200 for c, _ in shed)
        say(f"[serve] no token -> {c401}; a 70 kB body -> {c413}; 12 "
            f"concurrent requests at max_pending 2 -> {n200} x 200, "
            f"{len(n429)} x 429 (Retry-After {set(n429)}); /stats "
            f"{batcher.stats()}")
        if (c401, c413) != (401, 413) or not n429 or set(n429) != {"1"} \
                or n200 + len(n429) != 12:
            raise RuntimeError("[serve] 401, 413 or 429 missing")

        # grid="background": the other 19 shapes captured in a thread while
        # a burst of 32 is in flight (each request snaps to what is warm
        # when it is packed, so the burst's shapes vary): each wav within
        # WAV_ATOL (in int16 steps, +1 for the rounding) of its solo wav
        # outside the tail, and as long
        done = threading.Event()

        def log_background(msg):
            logs.append(msg)
            if "grid complete" in msg or "stopped" in msg:
                done.set()

        results.clear()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(32)]
        t0 = time.perf_counter()
        for t in threads[:16]:
            t.start()
        batcher.warmup(grid="background", log=log_background)
        for t in threads[16:]:
            t.start()
        for t in threads:
            t.join(300)
        done.wait(300)
        timings["warmup_background_s"] = time.perf_counter() - t0
        steps = WAV_ATOL * pp["audio"]["max_wav_value"] + 1
        diffs = []
        for i in range(32):
            text, code, body, _ = results[i]
            got, want = pcm(body), solo[text]
            head = len(want) - tail * hop
            diffs.append(np.inf if code != 200 or len(got) != len(want)
                         else float(np.abs(got[:head].astype(np.int32)
                                           - want[:head]).max()))
        say(f"[serve] warmup(grid=background) during a burst of 32: "
            f"{len(graphs.graphs)} graphs, {logs[-1]!r}; burst and grid "
            f"{timings['warmup_background_s']:.2f} s; each wav against its "
            f"solo wav outside the tail: largest difference "
            f"{max(diffs):g} int16 steps (tolerance {steps:g}); "
            f"{sum(d == 0 for d in diffs)} of 32 bit for bit")
        if any(t.is_alive() for t in threads) or not done.is_set():
            raise RuntimeError("[serve] the background warmup or its burst "
                               "did not finish")
        if len(graphs.graphs) != 20 or max(diffs) > steps:
            raise RuntimeError("[serve] grid=background did not make 20 "
                               "graphs, or the burst beside it went wrong")

        # grid="full" on top: the whole grid is warm, nothing is captured
        t0 = time.perf_counter()
        batcher.warmup(grid="full", log=logs.append)
        timings["warmup_full_s"] = time.perf_counter() - t0
        pool = graphs.pool_bytes()
        timings["pool_full_mb"] = None if pool is None else pool / 2**20
        say(f"[serve] warmup(grid=full) after it: {len(graphs.graphs)} "
            f"graphs, {timings['warmup_full_s']:.2f} s; the shared pool "
            f"{pool} bytes ({torch.cuda.memory_reserved() / 2**30:.2f} GiB "
            f"reserved in all); {logs[-1]!r}")
        if len(graphs.graphs) != 20 or len(syn._warm) != 20:
            raise RuntimeError("[serve] grid=full did not keep 20 graphs")
        graphs.reset_replays()
        code, _, body = post({"text": "One.", "long": False})
        shape = [k for k, g in graphs.graphs.items() if g.replays]
        say(f"[serve] after the full grid, a one-word request -> {code}, "
            f"dispatched at {shape}")
        if code != 200 or len(shape) != 1 or shape[0][0] != 1:
            raise RuntimeError("[serve] a one-word request did not snap to "
                               "a batch-1 graph")
    finally:
        server.stop()

    # K1, K2 and K4 at serving's shapes against their plain versions
    per_shape = {"K1": [], "K2": [], "K2_bf16": [], "K4": []}
    errors = {}
    bf16_errors = {}   # the bfloat16 K2 in ulps, by L
    for L in (128, 1000):
        lens = [L, 0] + [min(L, L // 2 + 7 * i) for i in range(14)]
        q, k, v, mask = attention_inputs(lens, L, device, seed=16)
        additive = torch.zeros(16, 1, 1, L, device=device).masked_fill(
            mask[:, None, None, :], -1e9)
        errors[("K1", L)] = (cuda_attention.fused_attention(q, k, v, mask)
                             - multi_head_attention(q, k, v, mask)
                             ).abs().max().item()
        per_shape["K1"].append(with_bound(dict(
            shape=[16, 2, L, 128],
            ms=cuda_time_ms(lambda: cuda_attention.fused_attention(
                q, k, v, mask)),
            **device_times(lambda: cuda_attention.fused_attention(
                q, k, v, mask)),
            plain_ms=cuda_time_ms(lambda: multi_head_attention(q, k, v,
                                                               mask)),
            library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=additive)),
            **device_times(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=additive), "library_")),
            attention_bound_ms(16, 2, L)))
        args = ffn_inputs(L, device, seed=17, B=16)
        packed = cuda_ffn.pack_ffn_weights(args[1], args[3])
        # the bfloat16 instance at the same shapes (serve --dtype bfloat16)
        bf_args = (args[0].to(torch.bfloat16),) + args[1:]
        bf_packed = cuda_ffn.pack_ffn_weights(args[1], args[3],
                                              torch.bfloat16)
        with torch.inference_mode():
            errors[("K2", L)] = (cuda_ffn.fused_conv_ffn(*args, packed=packed)
                                 - cuda_ffn.plain_conv_ffn(*args)
                                 ).abs().max().item()
            bf16_errors[L] = bf16_ulps(
                cuda_ffn.fused_conv_ffn(*bf_args, packed=bf_packed),
                cuda_ffn.plain_conv_ffn(*bf_args))
            per_shape["K2"].append(with_bound(dict(
                shape=[16, L, 256],
                ms=cuda_time_ms(lambda: cuda_ffn.fused_conv_ffn(
                    *args, packed=packed)),
                **device_times(lambda: cuda_ffn.fused_conv_ffn(
                    *args, packed=packed)),
                plain_ms=cuda_time_ms(lambda: cuda_ffn.plain_conv_ffn(*args)),
                library_ms=None), ffn_bound_ms(16, L)))
            per_shape["K2_bf16"].append(with_bound(dict(
                shape=[16, L, 256],
                ms=cuda_time_ms(lambda: cuda_ffn.fused_conv_ffn(
                    *bf_args, packed=bf_packed)),
                **device_times(lambda: cuda_ffn.fused_conv_ffn(
                    *bf_args, packed=bf_packed)),
                plain_ms=cuda_time_ms(
                    lambda: cuda_ffn.plain_conv_ffn(*bf_args)),
                library_ms=None), ffn_bound_ms(16, L, dtype="bfloat16"),
                BOUND_BASIS_BF16))
    del q, k, v, mask, additive, args, packed, bf_args, bf_packed
    # K4 at the iSTFT vocoder's six shapes, at serving's batch 16 and the
    # README's batch 1, beside cuDNN's chain autotuned with TF32 off
    for B, C, L in ((16, 256, 8000), (16, 128, 64000), (1, 256, 8000),
                    (1, 128, 64000)):
        iters = dict(iters=5, warmup=1) if B > 1 else {}
        for kk in (3, 7, 11):
            x, w1, b1, w2, b2 = resblock_inputs(C, L, kk, device,
                                                seed=C + kk)
            x = x.expand(B, -1, -1).contiguous()
            x = x + 0.1 * torch.randn(x.shape, device=device,
                                      generator=torch.Generator(
                                          device=device).manual_seed(kk))
            packed = cuda_resblock.pack_resblock_weights(w1, b1, w2, b2)
            with torch.inference_mode():
                got = cuda_resblock.fused_resblock(x, w1, b1, w2, b2,
                                                   DILATIONS, packed=packed)
                ref = cuda_resblock.plain_resblock(x, w1, b1, w2, b2,
                                                   DILATIONS)
                errors[("K4", B, C, kk)] = ((got - ref).abs().max()
                                            / ref.abs().max()).item()
                del got, ref
                t = dict(shape=[B, C, L], k=kk, ms=cuda_time_ms(
                    lambda: cuda_resblock.fused_resblock(
                        x, w1, b1, w2, b2, DILATIONS, packed=packed),
                    **iters), plain_ms=cuda_time_ms(
                    lambda: cuda_resblock.plain_resblock(
                        x, w1, b1, w2, b2, DILATIONS), **iters))
                with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                                deterministic=False,
                                                allow_tf32=False):
                    t["library_ms"] = cuda_time_ms(
                        lambda: cuda_resblock.plain_resblock(
                            x, w1, b1, w2, b2, DILATIONS), **iters)
            per_shape["K4"].append(with_bound(t, resblock_bound_ms(B, L, C,
                                                                    kk)))
            del x, packed
    for B in (16, 1):
        rows = [t for t in per_shape["K4"] if t["shape"][0] == B]
        say(f"[timing serve] K4, the six iSTFT ResBlock calls at batch {B}: "
            f"kernel {sum(t['ms'] for t in rows):.4f} ms, cuDNN autotuned "
            f"(TF32 off) {sum(t['library_ms'] for t in rows):.4f} ms, bound "
            f"{sum(t['bound_ms'] for t in rows):.4f} ms; kernel no slower "
            f"than cuDNN at every shape: "
            f"{all(t['ms'] <= t['library_ms'] for t in rows)} on {card}")
    for name, rows in per_shape.items():
        for t in rows:
            lib = ("null" if t["library_ms"] is None
                   else f"{t['library_ms']:.4f} ms")
            dev = (f" (device {t['dev_ms']:.4f} ms, profiler "
                   f"{t['prof_ms']:.4f}"
                   + (f"; SDPA's {t['library_dev_ms']:.4f} ms, profiler "
                      f"{t['library_prof_ms']:.4f}"
                      if "library_dev_ms" in t else "")
                   + f"; {t['bound_ms'] / t['dev_ms']:.1%} of the bound)"
                   if "dev_ms" in t else "")
            say(f"[timing serve] {name} {t['shape']}"
                f"{' k=' + str(t['k']) if 'k' in t else ''}: kernel "
                f"{t['ms']:.4f} ms{dev}, plain {t['plain_ms']:.4f} ms, "
                f"library {lib}, bound {t['bound_ms']:.3e} ms "
                f"({t['bound_by']}; {t['bound_basis']}) on {card}")
    say(f"[serve] kernels vs plain at serving's shapes (max_abs_diff; K4 "
        f"relative to the largest |value|): "
        f"{ {str(k): f'{v:.3e}' for k, v in errors.items()} } (tolerance "
        f"{KERNEL_ATOL:g})")
    say(f"[serve] the bfloat16 K2 vs plain at [16, 128|1000, 256], in "
        f"ulps of bfloat16 by L: {bf16_errors} (tolerance {BF16_ULPS})")
    if not all(v <= BF16_ULPS for v in bf16_errors.values()):
        raise RuntimeError("[serve] the bfloat16 K2 disagrees with its plain "
                           "version at serving's shapes")
    if not all(v <= KERNEL_ATOL for v in errors.values()):
        raise RuntimeError("[serve] a kernel disagrees with its plain "
                           "version at serving's shapes")
    torch.cuda.empty_cache()
    return {"launches": {"serving": launches}, "timings": timings,
            "per_shape": per_shape, "errors": errors}


def evaluation(device, card, features, tmp):
    """Phase 17, objective evaluation: evaluate --objective 2 --save_dir
    through the evaluate CLI's main on phase 13's features with 2 clips
    held out (their trimmed wavs; the loss pass over the same 2),
    the tracked acoustic npz and iSTFT snapshot (finite MCD and F0 rows,
    10 K1 + 10 K2 per acoustic forward, 6 K4 per vocoder forward), then
    prosody_sweep's main at 0.8/1.0/1.2 in both control modes on the
    README sentence (reported) and on the corpus's first train.txt
    sentence (verify passes).  The counts are set to 0 just before and read just after ->
    {"launches": {"evaluation": counts}, "timings": {...}}."""
    import numpy as np
    import torch

    from fastspeech2_tpu_torch.cli import evaluate_cli
    from fastspeech2_tpu_torch.evaluation import prosody_sweep

    save_dir = os.path.join(tmp, "objective")
    printed = io.StringIO()
    with record_forwards() as calls:
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            evaluate_cli.main([
                "-p", features["eval_yaml"], "-m",
                f"{CONFIG}/model.yaml", "-t", features["train_yaml"],
                "--weights_npz", ACOUSTIC_NPZ, "--vocoder_ckpt",
                VOCODER_NPZ, "--objective", "2", "--save_dir", save_dir])
        torch.cuda.synchronize()
        objective_s = time.perf_counter() - t0
        totals = launch_counts()
    lines = printed.getvalue().splitlines()
    rows = [json.loads(ln) for ln in lines if ln.startswith('{"name"')]
    per_forward = [c["launches"] for c in calls]
    loss_pass = {k: totals[k] - sum(c[k] for c in per_forward)
                 - (6 * len(rows) if k == "K4" else 0) for k in totals}
    say(f"[evaluate] evaluate_cli --objective 2 --save_dir on phase 13's "
        f"features, 2 clips held out ({objective_s:.2f} s): rows {rows}; "
        f"{lines[-1]!r}; launches {totals}: per objective forward "
        f"{per_forward}, 6 K4 per row's vocoder forward, the loss pass "
        f"{loss_pass}; written {sorted(os.listdir(save_dir))}")
    if len(rows) != 2 or not all(
            math.isfinite(r["mcd_db"]) and r["mcd_db"] > 0
            and math.isfinite(r["f0_rmse_hz"]) and 0 < r["voicing_f1"] <= 1
            for r in rows):
        raise RuntimeError("[evaluate] the objective rows are not two finite "
                           "MCD and F0 rows")
    want = dict.fromkeys(totals, 0)
    for c in calls:
        need = int(c["out"].duration_rounded.sum(dim=1).max())
        n = 2 if need > c["synth"].max_mel_len else 1
        if c["launches"] != dict(want, K1=10 * n, K2=10 * n):
            raise RuntimeError(f"[evaluate] an objective forward launched "
                               f"{c['launches']}")
    if len(calls) != 2 or loss_pass["K4"] != 0 or loss_pass["K1"] <= 0 \
            or any(v < 0 for v in loss_pass.values()):
        raise RuntimeError(f"[evaluate] launches {totals} do not split into "
                           "the loss pass and 10 K1 + 10 K2 + 6 K4 per "
                           "objective row")
    if not os.path.exists(os.path.join(save_dir, "metrics.json")):
        raise RuntimeError("[evaluate] no metrics.json")

    # the sweep on the README sentence (the sweep CLI's default text),
    # reported, and on the corpus's first train.txt sentence, gated
    with open(BATCH_SOURCE) as f:
        corpus_text = f.readline().rstrip("\n").split("|")[3]
    sweep_launches = dict.fromkeys(totals, 0)
    sweeps = {}
    for name, text in (("README", README_SENTENCE), ("corpus", corpus_text)):
        printed = io.StringIO()
        before = launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            out = prosody_sweep.main([
                "-p", f"{CONFIG}/preprocess.yaml", "-m",
                f"{CONFIG}/model.yaml", "-t", f"{CONFIG}/train.yaml",
                "--weights_npz", ACOUSTIC_NPZ, "--vocoder_ckpt", VOCODER_NPZ,
                "--text", text, "--save_dir", os.path.join(tmp, name)])
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        after = launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        checks = {mode: m["checks"] for mode, m in out["modes"].items()}
        voiced = {mode: {r: row.get("wav_f0_frames") for r, row in
                         m["results"]["pitch"].items()}
                  for mode, m in out["modes"].items()}
        say(f"[evaluate] prosody_sweep on the {name} sentence {text!r} at "
            f"{prosody_sweep.RATIOS} in both modes ({sweep_s:.2f} s): all_ok "
            f"{out['all_ok']}; checks {checks}; frames voiced in both the "
            f"x1.0 and each pitch point's wav {voiced}; launches {launched}"
            f"; index.html "
            f"{os.path.exists(os.path.join(tmp, name, 'index.html'))}")
        if launched != dict(want, K1=180, K2=180, K4=108):
            raise RuntimeError("[evaluate] the sweep's 18 points did not "
                               "each launch 10 K1 + 10 K2 + 6 K4")
        sweep_launches = {k: sweep_launches[k] + launched[k]
                          for k in launched}
        sweeps[name] = (out["all_ok"], sweep_s)
    if not sweeps["corpus"][0]:
        raise RuntimeError("[evaluate] prosody_sweep.verify failed on the "
                           "corpus sentence")
    launches = {k: totals[k] + sweep_launches[k] for k in totals}
    return {"launches": {"evaluation": launches},
            "timings": {"objective_s": objective_s,
                        "sweep_s": {k: v[1] for k, v in sweeps.items()},
                        "sweep_ok": {k: v[0] for k, v in sweeps.items()}}}


def host_ms(fn, n=5):
    """Median and min host ms of ``fn`` over n runs, the card synchronised
    around each."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times)


def _grad_errors(got, ref):
    """The first step's gradient of a run against another's -> {tensor:
    its max error over its largest |value|, floored at 1e-3 of the whole
    gradient's largest}, ZERO_GRADIENT tensors apart."""
    import numpy as np

    from fastspeech2_tpu_torch.tools.parallel_steps import ZERO_GRADIENT

    floor = 1e-3 * max(float(np.abs(g).max()) for g in ref.values())
    return {k: float(np.abs(got[k] - g).max()
                     / max(float(np.abs(g).max()), floor))
            for k, g in ref.items()
            if not any(re.fullmatch(p, k) for p in ZERO_GRADIENT)}


def _step_errors(got, ref, tol):
    """A parallel run's result against the one-process run's -> {losses:
    max relative error over the steps' six losses, grads: the largest of
    _grad_errors and grads_worst, the tensor where it is, per_tensor:
    _grad_errors, grad_norm: relative, first / last:
    parallel_steps.state_errors at ``tol`` of the state after the first
    step and after the last}."""
    import numpy as np

    from fastspeech2_tpu_torch.tools.parallel_steps import state_errors

    per_tensor = _grad_errors(got["grads"], ref["grads"])
    worst = max(per_tensor, key=per_tensor.get)
    return {"losses": float(np.max(np.abs(got["losses"] - ref["losses"])
                                   / np.abs(ref["losses"]))),
            "grads": per_tensor[worst], "grads_worst": worst,
            "per_tensor": per_tensor,
            "grad_norm": abs(got["grad_norm"] / ref["grad_norm"] - 1.0),
            "first": state_errors(got["after_first"], ref["after_first"],
                                  tol),
            "last": state_errors(got["state"], ref["state"], tol)}


def _channel_permutation(state, cfg, seed=0):
    """A symmetry of the model: in every FFT block the attention's heads
    rotated and each head's channels shuffled (the rows of w_qs and w_ks
    by one order, of w_vs and the columns of fc by another), and the FFN's
    hidden channels shuffled (the rows of w_1 and the columns of w_2) ->
    {state name: (dim, order)}, new = np.take(old, order, dim).  The
    model computes the same function in exact arithmetic, with every sum
    over heads, head channels or hidden channels in another order: the
    sums that tensor parallel splits."""
    import numpy as np

    rng = np.random.RandomState(seed)
    perms = {}
    for stack in ("encoder", "decoder"):
        n_head = getattr(cfg, f"{stack}_head")
        for i in range(getattr(cfg, f"{stack}_layer")):
            at = f"{stack}.layer_stack.{i}.slf_attn"
            ffn = f"{stack}.layer_stack.{i}.pos_ffn"
            dh = state[f"{at}.w_qs.weight"].shape[0] // n_head
            heads = np.roll(np.arange(n_head), 1)
            qk, v = (np.concatenate([h * dh + rng.permutation(dh)
                                     for h in heads]) for _ in range(2))
            hidden = rng.permutation(state[f"{ffn}.w_1.weight"].shape[0])
            for name, dim, order in (
                    ("w_qs", 0, qk), ("w_ks", 0, qk), ("w_vs", 0, v)):
                perms[f"{at}.{name}.weight"] = (dim, order)
                perms[f"{at}.{name}.bias"] = (dim, order)
            perms[f"{at}.fc.weight"] = (1, v)
            perms[f"{ffn}.w_1.weight"] = (0, hidden)
            perms[f"{ffn}.w_1.bias"] = (0, hidden)
            perms[f"{ffn}.w_2.weight"] = (1, hidden)
    return perms


def reordered_inputs(base, batch, cfg):
    """Three one-process float32 steps that equal the first step of
    ``base`` in exact arithmetic and sum in other orders, the float32
    noise the parallel runs' gradients are held to: "rows" (the batch's
    rows reversed: the sums over rows that data parallel splits),
    "channels" (:func:`_channel_permutation`) and "convolutions" (without
    cuDNN, whose algorithm is chosen by shape, as the ranks' smaller
    shapes choose theirs) -> ({name: spec for
    parallel_steps.acoustic_steps}, the permutation, for
    :func:`permuted_back`)."""
    import numpy as np

    B = len(batch["mel_lens"])
    rows = {k: (v[::-1].copy() if isinstance(v, np.ndarray) and v.ndim
                and v.shape[0] == B else
                v[::-1] if isinstance(v, list) and len(v) == B else v)
            for k, v in batch.items()}
    perms = _channel_permutation(base["state"], cfg)
    state = {k: np.take(v, perms[k][1], perms[k][0]) if k in perms else v
             for k, v in base["state"].items()}
    one = dict(base, data=1, model=1, dtype="float32")
    return {"rows": dict(one, batches=[rows]),
            "channels": dict(one, batches=[batch], state=state),
            "convolutions": dict(one, batches=[batch], cudnn=False)}, perms


def permuted_back(grads, perms):
    """A gradient of the channel-permuted model in the model's order."""
    import numpy as np

    return {k: np.take(g, np.argsort(perms[k][1]), perms[k][0])
            if k in perms else g for k, g in grads.items()}


def scan_training(device, card, tmp, pre_cfg, model_config, base_cfg):
    """Phase 10's scan sub-phase: the train CLI's main at its default
    dtype, bfloat16, with config/LJSpeech10/train.yaml's step block
    (scan_step 500) cut to SCAN_STEPS steps, log_step SCAN_LOG_STEP and
    validation and checkpoint at the end (K = SCAN_K), on phase 10's model
    and corpus with mel bucket SCAN_MEL_BUCKET (two shape groups).  Each
    step is a replay of its shape group's CUDA graph of the train step
    (training.step.make_scanned_train_step), but each group's first step,
    the warm-up that precedes its capture.  The per-step records come from
    the loop's step_hook; a step's launches are the wrappers' counts less
    what the captures counted, plus the graphs' replays times their
    captured launches.
    Holds: the "scan mode:" line (G >= 2, K = SCAN_K), the stacks' bytes
    and the graphs line (G graphs; capture seconds, pool bytes, beside the
    peak memory); 10 bfloat16 K1 and K3 a step and nothing else, every
    step but the G warm-ups a replay, the validation pass apart; every
    kernel input's first shape against its plain version; the run bit for
    bit equal to train_step fed the schedule (scan.schedule) with each
    batch copied from the host (the eager replay), every step's losses,
    every parameter and buffer and the logged loss lines; a second scan
    run bit for bit equal to the first; a float32 scan run of
    SCAN_F32_STEPS steps (10 float32 K1 and K3 a step) bit for bit equal
    to its eager replay.  Reports the ms a step of the graphed scan, the
    eager replay and the per-step path (scan_step 1, the same config) on
    one line, and the device's busy share over SCAN_WINDOW's steps of the
    second run -> {"launches": {"bf16 scan training": counts, "f32 scan
    training": counts}}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fastspeech2_tpu_torch.cli import train_cli
    from fastspeech2_tpu_torch.configs.config import FastSpeech2Config
    from fastspeech2_tpu_torch.training import loop as train_loop
    from fastspeech2_tpu_torch.training import scan
    from fastspeech2_tpu_torch.training.step import batch_to_device

    t_phase = time.perf_counter()
    with open(f"{CONFIG}/train.yaml") as f:
        yaml_step = yaml.safe_load(f)["step"]

    def step_block(total):
        steps = dict(yaml_step, total_step=total, log_step=SCAN_LOG_STEP,
                     val_step=total, save_step=total)
        if scan.dispatch_steps(steps["scan_step"], (
                steps["log_step"], steps["synth_step"], steps["val_step"],
                steps["save_step"]), total) != SCAN_K:
            raise RuntimeError(f"[scan] train.yaml's step block {yaml_step} "
                               f"does not give K = {SCAN_K} at {total} steps")
        return steps

    def configs(name, total, **over):
        train_cfg = dict(base_cfg, step=dict(step_block(total), **over),
                         bucket={"text": 128, "mel": SCAN_MEL_BUCKET},
                         path={k: os.path.join(tmp, f"scan_{name}", k)
                               for k in ("ckpt_path", "log_path",
                                         "result_path")})
        argv = []
        for kind, cfg in (("preprocess", pre_cfg), ("model", model_config),
                          ("train", train_cfg)):
            path = os.path.join(tmp, f"scan_{name}_{kind}.yaml")
            with open(path, "w") as f:
                yaml.safe_dump(cfg, f)
            argv += [f"-{kind[0]}", path]
        return argv, train_cfg

    inner_step = train_loop.train_step
    inner_train = train_cli.train
    inner_make = train_loop.make_scanned_train_step

    def run(name, window=None, total=SCAN_STEPS, dtype="bfloat16", **over):
        """The train CLI's main -> (model, train config, printed lines,
        per-step records, launch counts, (busy share, ms a step) of the
        profiler ``window``'s steps or Nones, the scanned runner or None);
        each step's launches, losses and host clock at its end recorded by
        the loop's step_hook, the counts set to 0 just before main."""
        argv, train_cfg = configs(name, total, **over)
        records, traced, made = [], {}, []
        last = {}

        def counts():
            """The launches the card ran so far: the wrappers' counts less
            what the captures counted, plus the graphs' replays."""
            now = launch_counts()
            if not made:
                return now
            replayed = made[0].launches()
            return {k: now[k] - made[0].captured_launches[k] + replayed[k]
                    for k in now}

        def hook(step, losses):
            if step in (1, SCAN_WINDOW[0], total):
                torch.cuda.synchronize()
            now = counts()
            records.append(dict(
                step=step - 1, end=time.perf_counter(),
                launches={k: now[k] - last[k] for k in now},
                replayed=sum(g.replays for g in made[0].graphs.values())
                if made else 0,
                losses=torch.stack(list(losses)).detach().clone()))
            last.update(now)
            if window and step == window[0]:
                torch.cuda.synchronize()
                traced["prof"] = profile(activities=[ProfilerActivity.CUDA])
                traced["prof"].start()
                traced["t0"] = time.perf_counter()
            if window and step == window[1]:
                torch.cuda.synchronize()
                traced["t1"] = time.perf_counter()
                traced["prof"].stop()

        def make(*args, **kwargs):
            made.append(inner_make(*args, **kwargs))
            return made[-1]

        printed = io.StringIO()
        train_cli.train = functools.partial(inner_train, step_hook=hook)
        train_loop.make_scanned_train_step = make
        zero_counts()
        last.update(launch_counts())
        try:
            with contextlib.redirect_stdout(printed):
                model, _, final = train_cli.main(argv + ["--dtype", dtype])
        finally:
            train_cli.train = inner_train
            train_loop.make_scanned_train_step = inner_make
        torch.cuda.synchronize()
        if final != total or len(records) != total:
            raise RuntimeError(f"[scan] the {name} run trained {final} "
                               f"steps, expected {total}")
        busy = window_ms = None
        if window:
            window_ms = (traced["t1"] - traced["t0"]) * 1e3 / (
                window[1] - window[0])
            trace = os.path.join(tmp, "scan_trace.json")
            traced["prof"].export_chrome_trace(trace)
            with open(trace) as f:
                events = json.load(f)["traceEvents"]
            os.remove(trace)
            kernels = [(e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") == "kernel"]
            if kernels:
                busy = _merged_us(kernels) / (
                    (traced["t1"] - traced["t0"]) * 1e6)
        for r in records:
            r["losses"] = r["losses"].float().cpu()
        return (model, train_cfg, printed.getvalue().splitlines(), records,
                counts(), (busy, window_ms), made[0] if made else None)

    def step_ms(records, after=1):
        """The mean ms a step over steps after+1 to N: the host clock from
        step ``after``'s end to the last's, the device synchronised at
        both (the duties between them included)."""
        return (records[-1]["end"] - records[after - 1]["end"]) * 1e3 / (
            len(records) - after)

    def eager_replay(train_cfg, dtype, total):
        """train_step on each batch of the schedule, copied from the host,
        from the run's seed and weights -> (model, [losses], ms a step,
        the schedule)."""
        model_r, cfg, optim_cfg, opt_r = train_loop.init_training(
            pre_cfg, model_config, train_cfg, device=device, dtype=dtype)
        model_r.train()
        groups = scan.gather_epoch(train_loop.train_loader(
            pre_cfg, train_cfg, FastSpeech2Config.build(pre_cfg,
                                                        model_config),
            optim_cfg.batch_size).epoch(0), 1 << 62)
        plan = scan.schedule([len(g) for g in groups], SCAN_K, 0, total)
        replay = []
        step = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for gi, idx in plan:
            for i in idx:
                losses = inner_step(model_r, opt_r, batch_to_device(
                    groups[gi][int(i)], device), step)
                replay.append(torch.stack(list(losses)))
                step += 1
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / total
        return model_r, [v.float().cpu() for v in replay], ms, plan

    def held_to_replay(what, model, records, lines, total, replay_model,
                       replay, plan):
        """Raises unless the run's losses, parameters and buffers (and
        its logged loss lines) are its eager replay's bit for bit."""
        loss_diff = max(float((a["losses"] - b).abs().max())
                        for a, b in zip(records, replay))
        state_a, state_r = model.state_dict(), replay_model.state_dict()
        state_diff = {k: float((state_a[k].float() - v.float()).abs().max())
                      for k, v in state_r.items()}
        logged = [ln for ln in lines if ln.startswith("Step ")]
        want_logged = [train_loop.loss_line(f"Step {s}/{total}",
                                            replay[s - 1].tolist())
                       for s in range(SCAN_LOG_STEP, total + 1,
                                      SCAN_LOG_STEP)]
        logged_ok = len(logged) == len(want_logged) and all(
            ln.startswith(w) for ln, w in zip(logged, want_logged))
        order = [(gi, idx.tolist()) for gi, idx in plan]
        say(f"[scan] {what} against train_step fed the schedule (group, "
            f"batches) {order} from the host: max |loss difference| "
            f"{loss_diff:.3e} over {len(replay)} steps, max |state "
            f"difference| {max(state_diff.values()):.3e} over "
            f"{len(state_diff)} tensors "
            f"({sum(v > 0 for v in state_diff.values())} differ); the "
            f"logged loss lines the replay's: {logged_ok}")
        if loss_diff != 0.0 or max(state_diff.values()) != 0.0 or \
                len(replay) != total or not logged_ok:
            raise RuntimeError(f"[scan] {what} is not train_step over its "
                               "schedule bit for bit")

    def check_steps(what, records, scanned, groups, want_step):
        """Raises unless every step launched ``want_step`` and nothing
        else, and every step but each group's first was a replay."""
        per_step = {tuple(sorted(r["launches"].items())) for r in records}
        replays = sum(g.replays for g in scanned.graphs.values())
        say(f"[scan] {what}: launches per step {[dict(t) for t in per_step]}"
            f" (captured launches x replays), {len(scanned.graphs)} graphs "
            f"for {groups} shape groups, {replays} replays of "
            f"{len(records)} steps")
        if per_step != {tuple(sorted(want_step.items()))}:
            raise RuntimeError(f"[scan] {what}: launches per step "
                               f"{per_step}, expected {want_step}")
        if len(scanned.graphs) != groups or \
                replays != len(records) - groups or \
                [r["replayed"] for r in records][-1] != replays:
            raise RuntimeError(f"[scan] {what}: {len(scanned.graphs)} "
                               f"graphs and {replays} replays, expected "
                               f"{groups} and {len(records) - groups}")
        if [r["step"] for r in records] != list(range(len(records))):
            raise RuntimeError("[scan] the steps did not run in order")
        if not all(torch.isfinite(r["losses"]).all() for r in records):
            raise RuntimeError("[scan] a loss is not finite")

    torch.cuda.reset_peak_memory_stats()
    with record_kernel_inputs() as scan_inputs:
        (model_a, train_cfg, lines, rec_a, counts_a, _,
         scanned_a) = run("a")
    peak = torch.cuda.max_memory_allocated()
    scan_line = next((ln for ln in lines if ln.startswith("scan mode: ")),
                     "")
    found = re.match(r"scan mode: (\d+) batches in (\d+) shape group\(s\) "
                     r"device-resident, (\d+) steps/dispatch", scan_line)
    stack_line = next((ln for ln in lines
                       if ln.startswith("scan mode stacks: ")), "")
    graphs_line = next((ln for ln in lines
                        if ln.startswith("scan mode graphs: ")), "")
    graphs_found = re.match(r"scan mode graphs: (\d+) captured in ([\d.]+) "
                            r"s, pool (\d+) bytes", graphs_line)
    say(f"[scan] {scan_line}")
    say(f"[scan] {stack_line}")
    say(f"[scan] {graphs_line}; peak memory {peak} bytes "
        f"(torch.cuda.max_memory_allocated over the run)")
    capture_s = float(graphs_found.group(2)) if graphs_found else None
    if not found or int(found.group(2)) < 2 or \
            int(found.group(3)) != SCAN_K or not stack_line:
        raise RuntimeError(f"[scan] expected a scan mode of >= 2 shape "
                           f"groups at K = {SCAN_K}:\n" + "\n".join(lines))
    n_groups = int(found.group(2))
    if not graphs_found or int(graphs_found.group(1)) != n_groups or \
            int(graphs_found.group(3)) <= 0:
        raise RuntimeError(f"[scan] expected the graphs line of "
                           f"{n_groups} graphs:\n" + "\n".join(lines))
    want = dict.fromkeys(counts_a, 0)
    check_steps("bf16", rec_a, scanned_a, n_groups,
                dict(want, K1_bf16=10, K3_bf16=10))
    val_counts = {k: counts_a[k] - sum(r["launches"][k] for r in rec_a)
                  for k in counts_a}
    check_recorded_inputs(scan_inputs, "scan kernels", card)
    say(f"[scan] launches in the validation pass at step {SCAN_STEPS} "
        f"{val_counts}")
    if val_counts != dict(want, K1_bf16=20, K2_bf16=20):
        raise RuntimeError(f"[scan] launches in the validation pass "
                           f"{val_counts}, expected 20 bfloat16 K1 + 20 "
                           "bfloat16 K2")
    del scanned_a

    # the eager replay of the schedule: the same seed and weights,
    # train_step on each scheduled batch copied from the host
    replay_model, replay, replay_ms, plan = eager_replay(
        train_cfg, torch.bfloat16, SCAN_STEPS)
    held_to_replay("the bf16 scan run", model_a, rec_a, lines, SCAN_STEPS,
                   replay_model, replay, plan)
    del replay_model

    # a second scan run, its steps SCAN_WINDOW under the profiler
    model_b, _, _, rec_b, _, (busy, window_ms), _ = run("b",
                                                         window=SCAN_WINDOW)
    state_a, state_b = model_a.state_dict(), model_b.state_dict()
    repro = max(float((state_a[k].float() - v.float()).abs().max())
                for k, v in state_b.items())
    repro_loss = max(float((a["losses"] - b["losses"]).abs().max())
                     for a, b in zip(rec_a, rec_b))
    say(f"[scan] two scan runs from one seed: max |state difference| "
        f"{repro:.3e}, max |loss difference| {repro_loss:.3e}")
    if repro != 0.0 or repro_loss != 0.0:
        raise RuntimeError("[scan] two scan runs from one seed differ")
    del model_a, model_b, state_a, state_b

    # the per-step path on the same config, for its host time
    _, _, lines_c, rec_c, _, _, _ = run("c", scan_step=1)
    if any(ln.startswith("scan mode: ") for ln in lines_c):
        raise RuntimeError("[scan] scan_step 1 ran scan mode")

    # a float32 scan run, held to its eager replay
    (model_f, train_cfg_f, lines_f, rec_f, counts_f, _,
     scanned_f) = run("f32", total=SCAN_F32_STEPS, dtype="float32")
    check_steps("f32", rec_f, scanned_f, n_groups, dict(want, K1=10, K3=10))
    del scanned_f
    replay_model, replay_f, replay_f_ms, plan = eager_replay(
        train_cfg_f, torch.float32, SCAN_F32_STEPS)
    held_to_replay("the float32 scan run", model_f, rec_f, lines_f,
                   SCAN_F32_STEPS, replay_model, replay_f, plan)
    del replay_model, model_f
    phase_s = time.perf_counter() - t_phase
    steady = SCAN_WINDOW[0]
    say(f"[scan] ms a step (host clock, the device synchronised at both "
        f"ends, the duties included): over steps 2-{SCAN_STEPS} (group 1's "
        f"warm-up and capture included) graphed scan {step_ms(rec_a):.2f}, "
        f"per-step path {step_ms(rec_c):.2f}; over steps {steady + 1}-"
        f"{SCAN_STEPS} (every scan step a replay) graphed scan "
        f"{step_ms(rec_a, steady):.2f}, per-step path "
        f"{step_ms(rec_c, steady):.2f}; eager replay {replay_ms:.2f} (steps "
        f"1-{SCAN_STEPS}, each batch from the host, no duties); float32: "
        f"graphed scan {step_ms(rec_f):.2f} over steps 2-{SCAN_F32_STEPS}, "
        f"eager replay {replay_f_ms:.2f}; capture {capture_s:.2f} s; the "
        f"device busy "
        + (f"{100 * busy:.1f}%" if busy is not None else "not measured "
           "(no kernel in the trace)")
        + f" of steps {SCAN_WINDOW[0] + 1}-{SCAN_WINDOW[1]} in scan mode "
        f"(torch.profiler, CUDA activity; {window_ms:.2f} ms a step in its "
        f"window); the sub-phase took {phase_s:.1f} s (budget "
        f"{SCAN_BUDGET_S} s); on {card}")
    return {"launches": {"bf16 scan training": counts_a,
                         "f32 scan training": counts_f}}


def parallel_training(device, card, features, tmp):
    """Phase 18, data and tensor parallel training on one card: two ranks
    on cuda:0 over gloo (NCCL refuses two ranks on one GPU), at full width
    on phase 13's features, against the one-process steps on the same
    global batches from the same weights, dropout 0 (the rank enters the
    dropout seed), run on rank 0 of the same world so that every compared
    step runs in a process of one kind: dp 2 at float32 and bfloat16, tp
    2 at float32 (K1 and K3 at one head per rank), the float32 gradient
    per tensor against its noise (:func:`reordered_inputs`), the train
    loop under dp 2 (rank 0 alone logs and writes the checkpoint), the
    GAN step at --data_parallel 2.
    K1 and K3 at [10, 1, L, 128] against their plain versions, timed
    beside SDPA.  Raises on a failed gate -> {"launches": {path: counts},
    "timings": {...}, "per_shape": {"K1": [...], "K3": [...]}}."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from fastspeech2_tpu_torch.configs.config import (
        FastSpeech2Config,
        OptimConfig,
        load_yaml_configs,
    )
    from fastspeech2_tpu_torch.data.dataset import (
        BucketedLoader,
        FeatureDataset,
    )
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.ops import cuda_attention
    from fastspeech2_tpu_torch.ops.attention import (
        multi_head_attention,
        plain_attention_backward,
    )
    from fastspeech2_tpu_torch.parallel.launch import run_ranks
    from fastspeech2_tpu_torch.tools import parallel_steps
    from fastspeech2_tpu_torch.synthesis.vocoder import GENERATOR_KEYS
    from fastspeech2_tpu_torch.tools.kernel_bounds import attention_bound_ms
    from fastspeech2_tpu_torch.training.optim import noam_schedule
    from fastspeech2_tpu_torch.training.step import TRAIN_SEED
    from fastspeech2_tpu_torch.utils.params_io import load_variables_npz

    pre, model_cfg, train_cfg = load_yaml_configs(
        features["preprocess_yaml"], f"{CONFIG}/model.yaml",
        features["train_yaml"])
    cfg = FastSpeech2Config.build(pre, model_cfg)
    train_cfg["optimizer"].update(batch_size=TRAIN_BATCH, grad_acc_step=1)
    optim = OptimConfig.build(train_cfg)
    bucket = train_cfg.get("bucket", {})
    loader = BucketedLoader(
        FeatureDataset("train.txt", pre), batch_size=TRAIN_BATCH,
        group_size=4, shuffle=True, drop_last=True,
        max_mel_len=cfg.max_seq_len, text_bucket=bucket.get("text", 32),
        mel_bucket=bucket.get("mel", 160))
    batches = [next(iter(loader.epoch(e))) for e in range(PAR_STEPS)]
    for b in batches:
        halves = [b["mel_lens"][:5], b["mel_lens"][5:]]
        if len(set(b["mel_lens"].tolist())) < 2 or \
                sum(halves[0]) == sum(halves[1]):
            raise RuntimeError("[parallel] a batch whose rows or halves do "
                               "not differ in length hides the traps")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(TRAIN_SEED)
        state = {k: v.numpy() for k, v in FastSpeech2(cfg).state_dict()
                 .items()}
    base = dict(cfg=cfg, optim=optim, state=state, batches=batches,
                dropout=False, device="cuda:0")
    shapes = sorted({(int(b["texts"].shape[1]),
                      min(int(b["mels"].shape[1]), cfg.max_seq_len))
                     for b in batches})
    say(f"[parallel] {PAR_STEPS} global batches of {TRAIN_BATCH} from phase "
        f"13's features (text, frames) {shapes}; mel_len per batch "
        f"{[b['mel_lens'].tolist() for b in batches]}")

    # the one-process steps and the reordered ones run on rank 0 of the
    # world (rank 1 sits them out), in a process like the parallel runs'
    launches, timings = {}, {}
    noise_specs, perms = reordered_inputs(base, batches[0], cfg)

    # the parallel runs: 2 ranks on cuda:0 over gloo, one world for all
    with open(VOC_CONFIG) as f:
        voc_cfg = json.load(f)
    gan_kw = dict(wav_dir=None,
                  finetune_from=pre["path"]["preprocessed_path"],
        out_dir=os.path.join(tmp, "gan_dp"), total_steps=PAR_GAN_STEPS,
        batch_size=16, segment_size=8192, mel_source="gt",
        generator_config={k: voc_cfg[k] for k in GENERATOR_KEYS
                          if k in voc_cfg},
        init_generator_params=load_variables_npz(VOCODER_NPZ)["params"],
        log_step=1, save_step=10 ** 6, aug_gain_db=3.0, device="cuda:0")
    loop_train = dict(train_cfg)
    loop_train["path"] = dict(train_cfg["path"],
                              ckpt_path=os.path.join(tmp, "dp_ckpt"),
                              log_path=os.path.join(tmp, "dp_log"))
    loop_train["step"] = dict(train_cfg["step"], total_step=PAR_LOOP_STEPS,
                              save_step=PAR_LOOP_STEPS, log_step=1,
                              synth_step=10 ** 6, val_step=10 ** 6)
    tasks = [("acoustic_steps", dict(base, data=1, model=1,
                                     dtype="float32")),
             ("acoustic_steps", dict(base, data=1, model=1,
                                     dtype="bfloat16")),
             ("acoustic_steps", noise_specs["rows"]),
             ("acoustic_steps", noise_specs["channels"]),
             ("acoustic_steps", noise_specs["convolutions"]),
             ("acoustic_steps", dict(base, data=2, model=1,
                                     dtype="float32")),
             ("acoustic_steps", dict(base, data=2, model=1,
                                     dtype="bfloat16")),
             ("acoustic_steps", dict(base, data=1, model=2,
                                     dtype="float32")),
             ("loop_steps", dict(preprocess_config=pre,
                                 model_config=model_cfg,
                                 train_config=loop_train, data=2, model=1,
                                 device="cuda:0", dtype=torch.bfloat16)),
             ("vocoder_steps", gan_kw)]
    t0 = time.perf_counter()
    ranks = run_ranks(parallel_steps.run_tasks, 2, (tasks,),
                      store_dir=tmp, backend="gloo", timeout=900)
    timings["world_s"] = time.perf_counter() - t0
    per_task = list(zip(*ranks))
    ref32, ref16, rows, channels, convs = (r[0] for r in per_task[:5])
    dp32, dp16, tp32, loop, gan = per_task[5:]
    ref = {"float32": ref32, "bfloat16": ref16}
    for dtype, one in ref.items():
        suffix = "_bf16" if dtype == "bfloat16" else ""
        launches[f"parallel one-process {dtype}"] = dict(
            dict.fromkeys(launch_counts(), 0),
            **{"K1" + suffix: one["launches"][0],
               "K3" + suffix: one["launches"][1]})
    # the float32 gradient's own noise, per tensor
    noise_runs = {
        "rows": _grad_errors(rows["grads"], ref32["grads"]),
        "channels": _grad_errors(permuted_back(channels["grads"], perms),
                                 ref32["grads"]),
        "convolutions": _grad_errors(convs["grads"], ref32["grads"])}
    noise = {k: max(e[k] for e in noise_runs.values())
             for k in noise_runs["rows"]}
    noise_loss = max(float(np.max(np.abs(r["losses"][0]
                                         - ref32["losses"][0])
                                  / np.abs(ref32["losses"][0])))
                     for r in (rows, channels, convs))

    def top(errors, n=5):
        return [(k, f"{errors[k]:.3e}") for k in
                sorted(errors, key=errors.get, reverse=True)[:n]]

    say(f"[parallel] the float32 first step's gradient against itself on "
        f"inputs equal in exact arithmetic, per tensor, largest first: "
        f"rows reversed {top(noise_runs['rows'])}; heads and channels "
        f"permuted {top(noise_runs['channels'])}; convolutions without "
        f"cuDNN {top(noise_runs['convolutions'])}; their losses within "
        f"{noise_loss:.3e}; on {card}")
    if max(noise.values()) > PAR_NOISE_MAX or noise_loss > PAR_LOSS_RTOL:
        raise RuntimeError("[parallel] a reordered step is not the same "
                           "step: the noise estimate is void")

    gates = {"float32": (PAR_LOSS_RTOL, PAR_PARAM_TOL, PAR_SHARE),
             "bfloat16": (PAR_LOSS_RTOL_BF16, PAR_PARAM_TOL_BF16,
                          PAR_SHARE_BF16)}
    lr = noam_schedule(cfg.encoder_hidden, optim.warm_up_step,
                       optim.anneal_steps, optim.anneal_rate)
    lr_first = float(lr(0))
    lr_sum = sum(float(lr(i)) for i in range(PAR_STEPS))
    for name, runs, dtype in (("dp 2", dp32, "float32"),
                              ("dp 2", dp16, "bfloat16"),
                              ("tp 2", tp32, "float32")):
        one = ref[dtype]
        loss_tol, param_tol, share = gates[dtype]
        errs = _step_errors(runs[0], one, param_tol)
        per_tensor = errs.pop("per_tensor")
        grads_ok = errs["grads"] <= PAR_GRAD_TOL_BF16
        if dtype == "float32":
            # each tensor against its own noise
            excess = {k: e / (PAR_NOISE_X * noise[k] + PAR_GRAD_ABS)
                      for k, e in per_tensor.items()}
            k = max(excess, key=excess.get)
            errs["grads_against_noise"] = dict(
                worst=k, error=per_tensor[k],
                **{n: e[k] for n, e in noise_runs.items()},
                ratio=excess[k])
            grads_ok = excess[k] <= 1.0
            say(f"[parallel] {name} {dtype}: gradient error per tensor, "
                f"largest first {top(per_tensor)}; the largest against "
                f"{PAR_NOISE_X} x the noise + {PAR_GRAD_ABS}: "
                f"{errs['grads_against_noise']}; on {card}")
        same = all(np.array_equal(runs[1]["state"][k], runs[0]["state"][k])
                   for k in one["state"])
        step_ms = [1e3 * float(np.median(r["step_s"][1:])) for r in runs]
        timings[f"{name} {dtype}"] = dict(
            step_ms=step_ms,
            one_process_ms=1e3 * float(np.median(one["step_s"][1:])),
            errors=errs)
        per_rank = [r["launches"] for r in runs]
        suffix = "_bf16" if dtype == "bfloat16" else ""
        launches[f"parallel {name} {dtype}"] = dict(
            dict.fromkeys(launch_counts(), 0),
            **{"K1" + suffix: sum(n[0] for n in per_rank),
               "K3" + suffix: sum(n[1] for n in per_rank)})
        say(f"[parallel] {name} {dtype}, {PAR_STEPS} steps at batch "
            f"{TRAIN_BATCH} (ranks {[r['place'] for r in runs]}): losses "
            f"{runs[0]['losses'][:, 0].tolist()} against one process "
            f"{one['losses'][:, 0].tolist()}; errors {errs} (learning rate "
            f"of the first step {lr_first:.3e}, summed {lr_sum:.3e}); "
            f"ranks' states bitwise equal {same}; median step {step_ms} ms "
            f"per rank against "
            f"{timings[f'{name} {dtype}']['one_process_ms']:.2f} in one "
            f"process; K1, K3 launches per rank {per_rank}; on {card}")
        first, last = errs["first"], errs["last"]
        if not (same and errs["losses"] <= loss_tol and grads_ok
                and errs["grad_norm"] <= loss_tol
                and first["share"] <= share and last["share"] <= share
                and first["running_mean"] <= param_tol
                and max(first["running_var"],
                        last["running_var"]) <= param_tol
                and last["running_mean"] <= param_tol + 0.2 * PAR_STEPS
                * lr_sum):
            raise RuntimeError(f"[parallel] {name} {dtype} differs from one "
                               f"process: {errs}")
        if per_rank != [(10 * PAR_STEPS, 10 * PAR_STEPS)] * 2:
            raise RuntimeError(f"[parallel] {name} {dtype}: K1, K3 launches "
                               f"per rank {per_rank}, expected 10 + 10 per "
                               "step")

    # the train loop under dp 2 with dropout on: rank 0 alone logs and
    # writes the whole checkpoint
    ckpts = sorted(os.listdir(loop_train["path"]["ckpt_path"]))
    timings["loop dp 2 bfloat16"] = dict(
        step_ms=[1e3 * float(np.median(r["step_s"][1:])) for r in loop],
        agree_ms=[1e3 * r["agree_s"] for r in loop])
    say(f"[parallel] train() under dp 2 at bfloat16, {PAR_LOOP_STEPS} "
        f"steps: rank 0 {loop[0]['log'][-2:]}, rank 1 logged "
        f"{len(loop[1]['log'])} lines; checkpoints {ckpts}; host ms "
        f"between updates (median of steps 2-{PAR_LOOP_STEPS}, the log "
        f"duty included) and of one preemption check (agree) per rank "
        f"{timings['loop dp 2 bfloat16']}; on {card}")
    if [r["step"] for r in loop] != [PAR_LOOP_STEPS] * 2 or loop[1]["log"] \
            or ckpts != [f"{PAR_LOOP_STEPS}.pth.tar"]:
        raise RuntimeError("[parallel] the loop under dp 2 did not train, "
                           "log and checkpoint from rank 0 alone")
    saved = torch.load(os.path.join(loop_train["path"]["ckpt_path"],
                                    ckpts[0]), map_location="cpu",
                       weights_only=True)
    if set(saved["model"]) != set(state):
        raise RuntimeError("[parallel] the dp checkpoint is not the whole "
                           "model")

    # the GAN step at --data_parallel 2 against one process
    t0 = time.perf_counter()
    gan_one = parallel_steps.vocoder_steps(0, 1, dict(
        gan_kw, out_dir=os.path.join(tmp, "gan_one")))
    timings["gan one-process s"] = time.perf_counter() - t0
    gan_err = {net: max(float(np.abs(gan[0][net][k] - v).max()
                              / max(float(np.abs(v).max()), 1e-3))
                        for k, v in gan_one[net].items())
               for net in ("gen", "disc")}
    gan_same = all(np.array_equal(gan[0][net][k], gan[1][net][k])
                   for net in ("gen", "disc") for k in gan_one[net])
    say(f"[parallel] GAN step at --data_parallel 2, batch 16 x 8192 (8 a "
        f"rank), gain augmentation on, {PAR_GAN_STEPS} steps: rank 0 "
        f"{gan[0]['log'][-1]!r}, one process {gan_one['log'][-1]!r}; "
        f"parameter error {gan_err}; ranks bitwise equal {gan_same}; "
        f"the world's tasks took {timings['world_s']:.1f} s, one-process "
        f"GAN {timings['gan one-process s']:.1f} s; on {card}")
    if not gan_same or max(gan_err.values()) > PAR_GAN_TOL:
        raise RuntimeError(f"[parallel] the data-parallel GAN step differs "
                           f"from one process: {gan_err}")

    # K1 and K3 at one head per rank: [10, 1, L, 128] for the path's L
    per_shape = {"K1": [], "K3": []}
    for P, T in shapes:
        for L in sorted({P, T}):
            if any(r["shape"][2] == L for r in per_shape["K1"]):
                continue
            g = torch.Generator(device="cpu").manual_seed(L)
            q, k, v, grad = (torch.randn(TRAIN_BATCH, 1, L, 128, generator=g)
                             .to(device) for _ in range(4))
            lens = torch.randint(L // 2, L + 1, (TRAIN_BATCH,), generator=g)
            lens[0] = L
            mask = (torch.arange(L)[None, :] >= lens[:, None]).to(device)
            out, row_max, row_sum = cuda_attention._launch_forward(
                q, k, v, mask, True)
            ref_out = multi_head_attention(q, k, v, mask)
            dq, dk, dv = cuda_attention.fused_attention_backward(
                q, k, v, mask, out, row_max, row_sum, grad)
            rq, rk, rv = plain_attention_backward(q, k, v, mask, grad)
            k1_err = (out - ref_out).abs().max().item()
            k3_err = max(((a - b).abs().max() / b.abs().max()).item()
                         for a, b in ((dq, rq), (dk, rk), (dv, rv)))
            additive = torch.zeros(TRAIN_BATCH, 1, 1, L, device=device
                                   ).masked_fill(mask[:, None, None, :], -1e9)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            sdpa = F.scaled_dot_product_attention(*leaves, attn_mask=additive)
            rows = {
                "K1": with_bound(dict(
                    shape=[TRAIN_BATCH, 1, L, 128], max_abs_err=k1_err,
                    ms=cuda_time_ms(lambda: cuda_attention._launch_forward(
                        q, k, v, mask, True)),
                    plain_ms=cuda_time_ms(lambda: multi_head_attention(
                        q, k, v, mask)),
                    library_ms=cuda_time_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, attn_mask=additive))),
                    attention_bound_ms(TRAIN_BATCH, 1, L)),
                "K3": with_bound(dict(
                    shape=[TRAIN_BATCH, 1, L, 128], max_rel_err=k3_err,
                    ms=cuda_time_ms(
                        lambda: cuda_attention.fused_attention_backward(
                            q, k, v, mask, out, row_max, row_sum, grad)),
                    plain_ms=cuda_time_ms(lambda: plain_attention_backward(
                        q, k, v, mask, grad)),
                    library_ms=cuda_time_ms(lambda: torch.autograd.grad(
                        sdpa, leaves, grad, retain_graph=True))),
                    attention_bound_ms(TRAIN_BATCH, 1, L, backward=True))}
            del sdpa, leaves
            for name, t in rows.items():
                per_shape[name].append(t)
                say(f"[parallel] {name} at [{TRAIN_BATCH}, 1, {L}, 128] "
                    f"(one head per rank): error "
                    f"{t.get('max_abs_err', t.get('max_rel_err')):.3e}; "
                    f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms,"
                    f" SDPA {t['library_ms']:.4f} ms, bound "
                    f"{t['bound_ms']:.3e} ms ({t['bound_by']}, 3xTF32) on "
                    f"{card}")
            if k1_err > KERNEL_ATOL or k3_err > KERNEL_ATOL:
                raise RuntimeError(f"[parallel] K1/K3 at one head, L {L}: "
                                   f"{k1_err:.3e}, {k3_err:.3e}")
    return {"launches": launches, "timings": timings, "per_shape": per_shape}


def serving_replicas(device, card):
    """Phase 19, serving over replicas: a Synthesizer over [cuda:0, cuda:0]
    (the serve CLI's --data_parallel 2 with one card's two copies) on the
    tracked weights, warm_shape(16, 128) (one graph per replica at
    [8 x 128]), a [16 x 128] dispatch of the corpus rows and the README
    sentence against the one-replica eager dispatch (whole int16 wavs,
    tails included, within REPLICA_LSB), K1, K2 and K4 launches per
    replica, both dispatches timed; serve_cli --data_parallel 2 raises
    with one card visible -> {"launches": {...}, "timings": {...}}."""
    import numpy as np
    import torch

    from fastspeech2_tpu_torch.cli import serve_cli
    from fastspeech2_tpu_torch.cli.synthesize_cli import (
        load_metadata_rows,
        load_model_for_inference,
    )
    from fastspeech2_tpu_torch.configs.config import load_yaml_configs
    from fastspeech2_tpu_torch.synthesis.pipeline import Synthesizer
    from fastspeech2_tpu_torch.synthesis.vocoder import get_vocoder
    from fastspeech2_tpu_torch.text import text_to_sequence

    pre, model_cfg, train_cfg = load_yaml_configs(
        f"{CONFIG}/preprocess.yaml", f"{CONFIG}/model.yaml",
        f"{CONFIG}/train.yaml")
    model, cfg = load_model_for_inference(pre, model_cfg, ACOUSTIC_NPZ,
                                          device)
    vocoder = get_vocoder(model_cfg, pre, VOCODER_NPZ, device)
    one = Synthesizer(model, cfg, pre, device, vocoder=vocoder)
    if pre["preprocessing"]["audio"]["max_wav_value"] != 32768.0:
        raise RuntimeError("[replicas] expected int16 full scale 32768")
    two = Synthesizer(model, cfg, pre, device, vocoder=vocoder,
                      devices=[torch.device("cuda:0")] * 2, snap_to_warm=True)
    t0 = time.perf_counter()
    two.warm_shape(16, 128)
    warm_s = time.perf_counter() - t0
    graphs = [sorted(r.graphs.graphs) for r in two.replicas]
    _, _, phones = load_metadata_rows(pre, BATCH_SOURCE)
    cleaners = pre["preprocessing"]["text"]["text_cleaners"]
    ids = [np.asarray(text_to_sequence(t, cleaners), np.int64)
           for t in phones] + [one.text_to_ids(README_SENTENCE)[0]]
    for r in two.replicas:
        r.launches = dict.fromkeys(r.launches, 0)
        r.graphs.reset_replays()
    zero_counts()
    wavs2, out2 = two.synthesize_ids(ids)
    torch.cuda.synchronize()
    per_replica = two.replica_launches()
    eager_counts = launch_counts()
    # one replica's eager dispatch at the same packed [16 x 128] shape
    packed = two._pack_batch(ids, None, snap=True)
    controls = (1.0, 1.0, 1.0, 0.0, 0.0)
    wav1, out1 = one.fused_forward(*packed, controls)
    hop = pre["preprocessing"]["stft"]["hop_length"]
    wavs1 = [np.clip(w * 32768.0, -32768, 32767).astype(np.int16)[:n * hop]
             for w, n in zip(wav1.cpu().numpy(), out1.mel_len.tolist())]
    lsb = max(int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())
              for a, b in zip(wavs1, wavs2))
    lens_equal = [len(a) for a in wavs1[:len(ids)]] == [len(b) for b in
                                                       wavs2]
    t_two = host_ms(lambda: two.synthesize_ids(ids))
    t_one = host_ms(lambda: one.fused_forward(*packed, controls))
    try:
        serve_cli.build_server(serve_cli.build_parser().parse_args([
            "-p", f"{CONFIG}/preprocess.yaml", "-m", f"{CONFIG}/model.yaml",
            "-t", f"{CONFIG}/train.yaml", "--weights_npz", ACOUSTIC_NPZ,
            "--vocoder_ckpt", VOCODER_NPZ, "--port", "0",
            "--data_parallel", "2"]))
        refused = None
    except ValueError as e:
        refused = str(e)
    say(f"[replicas] Synthesizer over [cuda:0, cuda:0]: warm_shape(16, 128) "
        f"{warm_s:.2f} s, graphs per replica {graphs}; a [16 x 128] "
        f"dispatch of {len(ids)} texts ({tuple(out2.src_pad_mask.shape)}): "
        f"the int16 wavs against one replica's eager dispatch, whole, tails "
        f"included: max {lsb} LSB, lengths equal {lens_equal}, mel_len "
        f"{out2.mel_len[:len(ids)].tolist()}; launches per replica "
        f"{per_replica} (the eager work counted outside the graphs "
        f"{eager_counts}); median {t_two[0]:.2f} ms two replicas, "
        f"{t_one[0]:.2f} ms one replica eagerly; serve_cli --data_parallel 2"
        f" with one card: {refused!r}; on {card}")
    want = dict.fromkeys(per_replica[0], 0)
    if lsb > REPLICA_LSB or not lens_equal:
        raise RuntimeError(f"[replicas] the replicas' wavs differ by {lsb} "
                           "LSB from one replica's")
    if graphs != [[(8, 128)]] * 2 or per_replica != [
            dict(want, K1=10, K2=10, K4=6)] * 2:
        raise RuntimeError("[replicas] not one [8 x 128] graph and 10 K1 + "
                           "10 K2 + 6 K4 per replica")
    if refused is None or "needs 2 cards, 1 visible" not in refused:
        raise RuntimeError("[replicas] serve_cli --data_parallel 2 did not "
                           "refuse one card")
    launches = {k: sum(r[k] for r in per_replica) for k in per_replica[0]}
    return {"launches": {"serving replicas": dict(
                dict.fromkeys(launch_counts(), 0), **launches)},
            "timings": {"two_ms": t_two, "one_ms": t_one, "warm_s": warm_s,
                        "lsb": lsb}}


def g2p_tooling(device, card, tmp):
    """Phase 20, the G2P tooling: mine_lexicon on the tracked metadata;
    train_g2p on the tracked lexicon/ljspeech-mined.txt at the default
    width, batch 512, 500 held out, G2P_EPOCHS epochs (time per epoch;
    greedy, beam-4 and rule accuracy and PER, and the tracked npz's on the
    same words; gate: beam 4 beats the rules); the written npz through
    NeuralG2P on the card and through the README sentence's frontend ->
    {"timings": {...}}."""
    from fastspeech2_tpu_torch.text import mine_lexicon, train_g2p
    from fastspeech2_tpu_torch.text.g2p import english_to_phones, read_lexicon
    from fastspeech2_tpu_torch.text.neural_g2p import (
        DEFAULT_WEIGHTS,
        NeuralG2P,
    )

    printed = io.StringIO()
    lex_out = os.path.join(tmp, "mined.txt")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        mine_lexicon.main(["--out", lex_out, "--eval", BATCH_SOURCE])
    mine_s = time.perf_counter() - t0
    say(f"[g2p] mine_lexicon on the tracked metadata ({mine_s:.2f} s): "
        f"{printed.getvalue().strip().splitlines()}")
    with open(lex_out) as f:
        if not sum(1 for _ in f):
            raise RuntimeError("[g2p] mine_lexicon wrote no words")

    lines = []
    npz = os.path.join(tmp, "g2p.npz")
    t0 = time.perf_counter()
    report = train_g2p.train("lexicon/ljspeech-mined.txt", npz, heldout=500,
                             epochs=G2P_EPOCHS, batch_size=512,
                             device=device, log=lines.append)
    train_s = time.perf_counter() - t0
    held = train_g2p.split_pairs(train_g2p.load_pairs(
        "lexicon/ljspeech-mined.txt"), 500, 0)[1]
    tracked = {f"beam{b}": train_g2p.evaluate(
        NeuralG2P(DEFAULT_WEIGHTS, beam=b, device=device).batch, held,
        f"tracked npz beam{b}", lambda *_: None) for b in (1, 4)}
    say(f"[g2p] train_g2p on lexicon/ljspeech-mined.txt, {G2P_EPOCHS} "
        f"epochs at batch 512, 500 held out: {train_s:.1f} s, "
        f"{1e3 * report['epoch_seconds']:.1f} ms per epoch; {lines}; the "
        f"tracked npz on the same held-out words (it may have trained on "
        f"them: no gate) {tracked}; on {card}")
    if not report["beam4"]["word_acc"] > report["rules"]["word_acc"]:
        raise RuntimeError(f"[g2p] beam 4 ({report['beam4']}) does not beat "
                           f"the rules ({report['rules']})")
    g2p = NeuralG2P(npz, beam=4, device=device)
    with open(f"{CONFIG}/preprocess.yaml") as f:
        lexicon = read_lexicon(yaml.safe_load(f)["path"]["lexicon_path"])
    with_lexicon = english_to_phones(README_SENTENCE, lexicon, g2p)
    neural_only = english_to_phones(README_SENTENCE, {}, g2p)
    say(f"[g2p] the written npz through NeuralG2P on {device}: "
        f"{g2p.batch(['hello', 'zyzzyva'])}; the README sentence's "
        f"frontend with it: {with_lexicon} (every word through it: "
        f"{neural_only})")
    if not neural_only or not with_lexicon:
        raise RuntimeError("[g2p] the written npz gave no phones")
    return {"timings": {"mine_s": mine_s, "train_s": train_s,
                        "epoch_s": report["epoch_seconds"],
                        "report": report, "tracked": tracked}}


def leave_one_out(device, card, features, tmp):
    """Phase 21, leave-one-out at a cut (LOO_* steps) through the port's
    CLIs on phase 13's features, one fold; then the vocoder ladder on the
    tracked iSTFT snapshot and the fold's vocoder checkpoint, in one
    process (6 K4 per copy-synthesis forward) -> {"launches": {...},
    "timings": {...}}."""
    from pathlib import Path

    import torch

    from fastspeech2_tpu_torch.tools import leave_one_out as loo
    from fastspeech2_tpu_torch.tools.score_vocoder_ladder import score_ladder

    with open(features["preprocess_yaml"]) as f:
        fold_base = yaml.safe_load(f)["path"]["preprocessed_path"]
    loo.BASE_PRE = Path(fold_base)
    with open(os.path.join(fold_base, "train.txt")) as f:
        fold = f.readline().split("|")[0]
    out_root = os.path.join(tmp, "loo")
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        loo.main(["--folds", fold, "--out_root", out_root,
                  "--acoustic_steps", str(LOO_ACOUSTIC_STEPS),
                  "--voc_stage_a", str(LOO_VOC_STEPS), "--voc_stage_b",
                  str(LOO_VOC_STEPS), "--voc_scan", str(LOO_VOC_STEPS),
                  "--skip_train_eval"])
    loo_s = time.perf_counter() - t0
    summary = json.loads(Path(out_root, "summary.json").read_text())
    result = summary["folds"][f"{fold}:vocoder"]
    say(f"[loo] one fold ({fold} held out) at a cut: {LOO_ACOUSTIC_STEPS} "
        f"acoustic steps, {LOO_VOC_STEPS} + {LOO_VOC_STEPS} vocoder steps, "
        f"through the port's CLIs in {loo_s:.1f} s: held-out "
        f"{result['heldout'].get('objective_mean')}; copy synthesis "
        f"{result['copysyn']}")
    voc_ckpt = os.path.join(out_root, fold, "vocoder",
                            f"{2 * LOO_VOC_STEPS}.pth.tar")
    wavs = [result["copysyn"][k]["file"] for k in ("heldout",
                                                    "train_anchor")]
    zero_counts()
    t0 = time.perf_counter()
    rows = score_ladder("HiFi-GAN-iSTFT", [VOCODER_NPZ, voc_ckpt], wavs,
                        device=device, log=lambda *_: None)
    torch.cuda.synchronize()
    ladder_s = time.perf_counter() - t0
    counts = launch_counts()
    say(f"[loo] score_vocoder_ladder on {[VOCODER_NPZ, voc_ckpt]} over "
        f"{len(wavs)} clips ({ladder_s:.1f} s): {rows}; launches {counts}")
    if [r["n_files"] for r in rows] != [2, 2] or counts["K4"] != 6 * 4:
        raise RuntimeError("[loo] the ladder did not score 2 clips per "
                           "checkpoint with 6 K4 per copy synthesis")
    if result["copysyn"]["heldout"]["file"] == \
            result["copysyn"]["train_anchor"]["file"]:
        raise RuntimeError("[loo] the copy-synthesis rows are one clip")
    return {"launches": {"vocoder ladder": counts},
            "timings": {"loo_s": loo_s, "ladder_s": ladder_s}}


def main():
    import torch

    started = time.perf_counter()
    # each phase's wall seconds, for the [total] line
    phase_s, lapped = {}, [started]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = phase_s.get(name, 0.0) + now - lapped[0]
        lapped[0] = now

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(HANG_S, exit=True)
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

    lap("1 card")
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
                 "mha_bwd_f32_kernel": lib.fs2_mha_bwd_blocks_per_sm(),
                 "mha_fwd_bf16_kernel": lib.fs2_mha_fwd_bf16_blocks_per_sm(),
                 "mha_bwd_dq_bf16_kernel":
                     lib.fs2_mha_bwd_bf16_dq_blocks_per_sm(),
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
    say(f"[build] tensor-core instructions in the SASS (HMMA: mma.sync, "
        f"HGMMA: wgmma; summed over a template's instances): "
        f"{'not measured (no cuobjdump)' if hmma is None else hmma}")
    if hmma is not None and not all(hmma.get(n, {}).get("HGMMA", 0) > 0
                                    for n in WGMMA_KERNELS):
        raise RuntimeError("a kernel that multiplies (K1, K2 and K3 at both "
                           "dtypes, K4) has no HGMMA (wgmma) instruction")
    if hmma is not None and any(hmma.get(n, {}).get("HMMA", 0)
                                for n in WGMMA_KERNELS):
        raise RuntimeError("a kernel that multiplies holds an HMMA "
                           "(mma.sync) instruction")
    wgmma_build = wgmma_instances(info.get("ptxas", ""), info["path"], lib)
    say("[build] the float32 K1, K2 and K3 and the bfloat16 K2 on wgmma, "
        "by instance: " + "; ".join(
        f"{r['kernel']}: {r['registers']} registers, {r['spill_bytes']} "
        f"bytes of spill, {r['smem_bytes']} bytes of shared memory, HGMMA "
        f"{r['HGMMA']}, HMMA {r['HMMA']}" for r in wgmma_build))
    if len(wgmma_build) != 6 or any(
            r["spill_bytes"] or (hmma is not None and (
                not r["HGMMA"] or r["HMMA"])) for r in wgmma_build):
        raise RuntimeError(f"the float32 K1, K2 or K3 or the bfloat16 K2: an "
                           f"instance is missing, spills, or is not on wgmma "
                           f"alone (HGMMA, no HMMA): {wgmma_build}")
    k4_build = k4_instances(info.get("ptxas", ""), info["path"], lib)
    say("[build] K4's instances (output channels per block, conv of the "
        "unit): " + "; ".join(
            f"nb {r['nb']} {'first' if r['first'] else 'second'}: "
            f"{r['registers']} registers, {r['spill_bytes']} bytes of "
            f"spill, {r['smem_bytes']} bytes of shared memory, HGMMA "
            f"{r['HGMMA']}, HMMA {r['HMMA']}" for r in k4_build))
    if len(k4_build) != 8 or any(
            r["spill_bytes"] or (hmma is not None and (
                not r["HGMMA"] or r["HMMA"])) for r in k4_build):
        raise RuntimeError(f"K4: an instance is missing, spills, or is not "
                           f"on wgmma alone (HGMMA, no HMMA): {k4_build}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dt in (torch.float32, torch.bfloat16):
        k1_grids = {(B, L): cuda_attention.forward_plan(B, 2, L, dt)[0]
                    for B, L in ((1, 32), (1, 1000), (TRAIN_BATCH, 128),
                                 (TRAIN_BATCH, 768), (TRAIN_BATCH, 1000))}
        say(f"[build] K1's grid at {dt} (query tiles, B*H, key chunks) at "
            f"[B, 2, L, 128], by (B, L): {k1_grids}; "
            f"{math.prod(k1_grids[(1, 1000)])} blocks at [1, 2, 1000, 128] "
            f"on {sms} SMs")
    k3_scratch = {(dt, B, L): lib.fs2_mha_bwd_scratch_floats(B, 2, L, dt)
                  for dt in (0, 1)
                  for B, L in ((TRAIN_BATCH, 1000), (TRAIN_BATCH, 2000),
                               (2, 2000))}
    say(f"[build] K3's scratch (float32 elements) at [B, 2, L, 128], by "
        f"(bfloat16, B, L): {k3_scratch} (B*2*L at both dtypes: D alone)")
    if any(n != B * 2 * L for (_, B, L), n in k3_scratch.items()):
        raise RuntimeError("K3's scratch is not B*H*L floats")
    k1_host = k1_host_times(device)
    say(f"[build] K1's wrapper, host microseconds per call (the median "
        f"of {K1_HOST_REPS} runs of {K1_HOST_CALLS} calls issued back to "
        f"back) beside the kernel's own time (CUDA events around one launch, "
        f"median) and the CUDA-event time per call of 20 back-to-back calls "
        f"(the timing lines' measure): "
        + "; ".join(f"{dt} [{B}, 2, {L}, 128]{' with stats' if st else ''}"
                    f" host {h:.1f} us, kernel {k:.1f} us, events {e:.1f} "
                    f"us" for (dt, B, L, st), (h, k, e) in k1_host.items())
        + f" on {card}")
    for dt in (torch.float32, torch.bfloat16):
        k2_plans = {(B, L, k2): cuda_ffn.forward_plan(B, L, 1024, 9, k2, dt)
                    for B, L, k2 in k2_shapes + ((16, 128, 1),
                                                 (16, 1000, 1))}
        say(f"[build] K2's plan at {dt} (tap splits of the first conv, "
            f"hidden groups of the second; 1 group: the LayerNorm in the "
            f"second conv's epilogue) at [B, L, 256] -> 1024, by (B, L, "
            f"k2): {k2_plans}")

    lap("2 build")
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

    lap("3 K1")
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

    lap("4 K2")
    # 5. K3 vs plain at the training slice's L (decoder 1000, LJSpeech10's
    #    bucket 768, encoder 128), batch 10 with one full, one fully padded
    #    and partly padded rows; at one head a rank (tensor parallel 2); and
    #    at [2, 2, 2000, 128] (the scratch is D alone); each launched twice
    #    (bitwise equal)
    k3_err = k3_rel = 0.0
    k3_repeat = True
    k3_shapes = ((TRAIN_BATCH, 2, 1000), (TRAIN_BATCH, 2, 768),
                 (TRAIN_BATCH, 2, 128), (2, 2, 2000), (TRAIN_BATCH, 1, 1000),
                 (TRAIN_BATCH, 1, 128))
    for B, H, L in k3_shapes:
        q, k, v, mask, g = attention_grad_inputs(L, device, seed=L + 5, B=B)
        q, k, v, g = (t[:, :H].contiguous() for t in (q, k, v, g))
        out, row_max, row_sum = cuda_attention._launch_forward(
            q, k, v, mask, True)
        got = cuda_attention.fused_attention_backward(
            q, k, v, mask, out, row_max, row_sum, g)
        again = cuda_attention.fused_attention_backward(
            q, k, v, mask, out, row_max, row_sum, g)
        torch.cuda.synchronize()
        k3_repeat = k3_repeat and all(torch.equal(a, b)
                                      for a, b in zip(got, again))
        ref = plain_attention_backward(q, k, v, mask, g)
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            if not torch.isfinite(a).all():
                raise RuntimeError(f"K3 {name} not finite at [{B}, {H}, {L}, "
                                   f"128]")
            err = (a - b).abs().max().item()
            k3_err = max(k3_err, err)
            k3_rel = max(k3_rel, err / b.abs().max().item())
        del got, again, ref
    say(f"[K3] attention-backward kernel vs plain at [B, H, L, 128] for "
        f"(B, H, L) in {k3_shapes}, one full, one fully padded and partly "
        f"padded rows: max_abs_err={k3_err:.3e}, max relative to the "
        f"largest |grad| {k3_rel:.3e} (tolerance {K3_RTOL:g} relative); two "
        f"launches bitwise equal: {k3_repeat}")
    if not k3_rel <= K3_RTOL:
        raise RuntimeError("K3 disagrees with its plain version")
    if not k3_repeat:
        raise RuntimeError("K3 is not bitwise repeatable")
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
    # K3's score contract: K3a recomputes every score through K1's routine
    # with Q's small parts from registers (route 3), K3b through the K-as-A
    # route (S^T = K Q^T, route 2); K1 forms them through route 1, with the
    # same split operands in the same k order.  The raw scores S = Q K^T
    # through every route must agree bit for bit, or K3's P would not be
    # K1's
    contract = {}
    for B, L in ((TRAIN_BATCH, 1000), (2, 2000)):
        gen = torch.Generator(device="cpu").manual_seed(B + L)
        q, k = (torch.randn(B, 2, L, 128, generator=gen).to(device)
                for _ in range(2))
        routes = []
        for route in (1, 2, 3):
            scores = torch.empty(B, 2, L, L, device=device)
            cuda_build.check(lib.fs2_mha_scores_f32(
                q.data_ptr(), k.data_ptr(), scores.data_ptr(), B, 2, L,
                route, torch.cuda.current_stream().cuda_stream),
                "fs2_mha_scores_f32")
            routes.append(scores)
        torch.cuda.synchronize()
        contract[(B, L)] = tuple(
            (torch.equal(routes[0], r), int((routes[0] != r).sum().item()))
            for r in routes[1:])
        del routes, scores, q, k
    torch.cuda.empty_cache()
    say(f"[K3 contract] raw scores Q K^T through K1's routine (route 1) "
        f"against K3b's K-as-A route (2) and K3a's (3, Q's small parts "
        f"from registers) at [B, 2, L, 128], by (B, L): ((bitwise equal, "
        f"elements that differ) for routes 2 and 3) {contract}")
    if not all(eq for pair in contract.values() for eq, _ in pair):
        raise RuntimeError("K3's scores are not K1's bit for bit")

    # the bfloat16 instances of K1, K2 and K3 against their plain versions
    bf16_errors = bf16_kernel_checks(device, bshapes, k2_shapes)

    lap("5 K3")
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

    lap("6 K4")
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

    # the same sentence's float32 forward against the JAX package's result
    # on the CPU (the committed fixture)
    readme_fixture_check(device, card)

    lap("7 synthesis")
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

    lap("8 parity and options")
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
            **device_times(lambda: cuda_attention.fused_attention(
                q, k, v, mask)),
            plain_ms=cuda_time_ms(lambda: multi_head_attention(q, k, v, mask)),
            library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=additive)),
            **device_times(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=additive), "library_")),
            attention_bound_ms(1, 2, L))
    # ... and at batch mode's shapes, batch 8 and 2 (one full, one fully
    #    padded and partly padded rows)
    B8, enc8, _ = bshapes[0]
    for B, enc, _ in bshapes:
        for L in (enc, 1000):
            q, k, v, mask, _ = attention_grad_inputs(L, device, seed=8, B=B)
            additive = torch.zeros(B, 1, 1, L, device=device).masked_fill(
                mask[:, None, None, :], -1e9)
            timings[("K1", B, L)] = with_bound(dict(
                ms=cuda_time_ms(lambda: cuda_attention.fused_attention(
                    q, k, v, mask)),
                **device_times(lambda: cuda_attention.fused_attention(
                    q, k, v, mask)),
                plain_ms=cuda_time_ms(lambda: multi_head_attention(
                    q, k, v, mask)),
                library_ms=cuda_time_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=additive)),
                **device_times(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=additive), "library_")),
                attention_bound_ms(B, 2, L))
    # K2 as the model calls it, its weight pack made once: the README
    # sentence's encoder and decoder, batch mode's batch-8 forward, the
    # validation forward at batch 10, and every shape of K2_SHAPES
    k2_timed = {(1, enc_len, 1), (1, 1000, 1), (B8, enc8, 1), (B8, 1000, 1),
                (TRAIN_BATCH, 128, 1), (TRAIN_BATCH, 1000, 1)}
    k2_timed |= set(K2_SHAPES)
    # (the 3-tap second conv's rows apart, in k2_taps3)
    k2_taps3 = {}
    for B, L, k2 in sorted(k2_timed):
        args = ffn_inputs(L, device, seed=9, B=B, k2=k2)
        packed = cuda_ffn.pack_ffn_weights(args[1], args[3])
        with torch.inference_mode():
            (timings if k2 == 1 else k2_taps3)[("K2", B, L)] = with_bound(
                dict(ms=cuda_time_ms(lambda: cuda_ffn.fused_conv_ffn(
                         *args, packed=packed)),
                     **device_times(lambda: cuda_ffn.fused_conv_ffn(
                         *args, packed=packed)),
                     plain_ms=cuda_time_ms(
                         lambda: cuda_ffn.plain_conv_ffn(*args)),
                     library_ms=None, taps=[9, k2]),
                ffn_bound_ms(B, L, taps=(9, k2)))

    for (name, B, L), t in sorted(timings.items()) + sorted(k2_taps3.items()):
        lib = ("null" if t["library_ms"] is None
               else f"{t['library_ms']:.4f} ms")
        dev = (f" (device {t['dev_ms']:.4f} ms, profiler "
               f"{t['prof_ms']:.4f}"
               + (f"; SDPA's {t['library_dev_ms']:.4f} ms, profiler "
                  f"{t['library_prof_ms']:.4f}"
                  if t.get("library_dev_ms") is not None else "")
               + ")" if t.get("dev_ms") is not None else "")
        say(f"[timing] {name} B={B} L={L}"
            f"{' taps=' + str(t['taps']) if 'taps' in t else ''}: kernel "
            f"{t['ms']:.4f} ms{dev}, plain "
            f"{t['plain_ms']:.4f} ms, library {lib}, bound "
            f"{t['bound_ms']:.3e} ms ({t['bound_by']}; {t['bound_basis']}); "
            f"device share of the bound "
            f"{t['bound_ms'] / t.get('dev_ms', t['ms']):.1%}; "
            f"SIMT bound {t['simt_bound_ms']:.3e} ms on {card}")

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
        # K3 and SDPA's backward also by device time (SDPA's backward: all
        # the kernels of the autograd call)
        k3_call = (lambda: cuda_attention.fused_attention_backward(  # noqa
            q, k, v, mask, out, row_max, row_sum, g))
        sdpa_bwd = (lambda: torch.autograd.grad(  # noqa: E731
            sdpa_out, leaves, g, retain_graph=True))
        train_timings[("K3", L)] = with_bound(dict(
            ms=cuda_time_ms(k3_call), **device_times(k3_call),
            plain_ms=cuda_time_ms(lambda: plain_attention_backward(
                q, k, v, mask, g)),
            library_ms=cuda_time_ms(sdpa_bwd),
            **device_times(sdpa_bwd, "library_")),
            attention_bound_ms(TRAIN_BATCH, 2, L, backward=True))
        train_timings[("K1", L)] = with_bound(dict(
            ms=cuda_time_ms(lambda: cuda_attention._launch_forward(
                q, k, v, mask, True)),
            **device_times(lambda: cuda_attention._launch_forward(
                q, k, v, mask, True)),
            plain_ms=cuda_time_ms(lambda: multi_head_attention(q, k, v,
                                                               mask)),
            library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=additive)),
            **device_times(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=additive), "library_")),
            attention_bound_ms(TRAIN_BATCH, 2, L))
        del sdpa_out, leaves
    for (name, L), t in sorted(train_timings.items()):
        dev = (f" (device {t['dev_ms']:.4f} ms, profiler "
               f"{t['prof_ms']:.4f}; SDPA's {t['library_dev_ms']:.4f} ms, "
               f"profiler {t['library_prof_ms']:.4f})" if "dev_ms" in t
               else "")
        if name == "K3" and t["bound_by"] == "operations":
            dev += (f"; the design's own floor, 14 L^2 Dh of 3xTF32 "
                    f"operations where the formula's bound counts 10: "
                    f"{t['bound_ms'] * 1.4:.3e} ms")
        say(f"[timing] {name} at [10, 2, {L}, 128] (training): kernel "
            f"{t['ms']:.4f} ms{dev}, plain {t['plain_ms']:.4f} ms, library "
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
    # ... K1 at batch mode's shapes ([8, 2, 128|1000, 128], [2, 2,
    #     112|1000, 128]; one full, one fully padded and partly padded rows)
    for B, enc, _ in bshapes:
        for L in (enc, 1000):
            q, k, v, mask, _ = attention_grad_inputs(L, device, seed=8, B=B)
            q, k, v = (t.to(bf) for t in (q, k, v))
            additive = torch.zeros(B, 1, 1, L, device=device).masked_fill(
                mask[:, None, None, :], -1e9).to(bf)
            bf16_timings[("K1", B, L)] = with_bound(dict(
                ms=cuda_time_ms(lambda: cuda_attention.fused_attention(
                    q, k, v, mask)),
                plain_ms=cuda_time_ms(lambda: multi_head_attention(
                    q, k, v, mask)),
                library_ms=cuda_time_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=additive))),
                attention_bound_ms(B, 2, L, dtype="bfloat16"),
                BOUND_BASIS_BF16)
    # ... and K2 at every shape of the bfloat16 paths and of K2_SHAPES
    #     (the 3-tap second conv's [1, 48] among them), the re-dispatch's
    #     [1, 1536] and batch mode's batch-8 forward included, also by
    #     device time
    for B, L, k2 in sorted({(1, enc_len, 1), (B8, enc8, 1), (B8, 1000, 1)}
                           | set(K2_SHAPES)):
        args = ffn_inputs(L, device, seed=9, B=B, k2=k2)
        args = (args[0].to(bf),) + args[1:]
        packed = cuda_ffn.pack_ffn_weights(args[1], args[3], bf)
        with torch.inference_mode():
            bf16_timings[("K2", B, L)] = with_bound(dict(
                ms=cuda_time_ms(lambda: cuda_ffn.fused_conv_ffn(
                    *args, packed=packed)),
                **device_times(lambda: cuda_ffn.fused_conv_ffn(
                    *args, packed=packed)),
                plain_ms=cuda_time_ms(lambda: cuda_ffn.plain_conv_ffn(*args)),
                library_ms=None, taps=[9, k2]),
                ffn_bound_ms(B, L, taps=(9, k2), dtype="bfloat16"),
                BOUND_BASIS_BF16)
    for (name, B, L), t in sorted(bf16_timings.items()):
        lib = ("null" if t["library_ms"] is None
               else f"{t['library_ms']:.4f} ms")
        dev = (f" (device {t['dev_ms']:.4f} ms, profiler "
               f"{t['prof_ms']:.4f}; share of the bound "
               f"{t['bound_ms'] / t['dev_ms']:.1%})"
               if t.get("dev_ms") else "")
        say(f"[timing] {name} bfloat16 B={B} L={L}"
            f"{' taps=' + str(t['taps']) if 'taps' in t else ''}: kernel "
            f"{t['ms']:.4f} ms{dev}, plain {t['plain_ms']:.4f} ms, library "
            f"(bfloat16) {lib}, "
            f"bound {t['bound_ms']:.3e} ms ({t['bound_by']}; "
            f"{t['bound_basis']}) on {card}")
    # ... and the bfloat16 K1 and K3 where the other paths would run them:
    #     the serve CLI at --dtype bfloat16 ([16, 2, 128|1000, 128]) and a
    #     tensor-parallel step at bfloat16 (one head a rank, [10, 1, L, 128])
    bf16_other = []
    for B, H, L, backward in ((16, 2, 128, False), (16, 2, 1000, False),
                              (TRAIN_BATCH, 1, 128, False),
                              (TRAIN_BATCH, 1, 1000, False),
                              (TRAIN_BATCH, 1, 128, True),
                              (TRAIN_BATCH, 1, 1000, True)):
        q, k, v, mask, g = attention_grad_inputs(L, device, seed=L + H, B=B)
        if H == 1:
            q, k, v, g = (t[:, :1].contiguous() for t in (q, k, v, g))
        q, k, v, g = (t.to(bf) for t in (q, k, v, g))
        additive = torch.zeros(B, 1, 1, L, device=device).masked_fill(
            mask[:, None, None, :], -1e9).to(bf)
        if backward:
            out, row_max, row_sum = cuda_attention._launch_forward(
                q, k, v, mask, True)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            sdpa_out = F.scaled_dot_product_attention(*leaves,
                                                      attn_mask=additive)
            t = with_bound(dict(
                ms=cuda_time_ms(
                    lambda: cuda_attention.fused_attention_backward(
                        q, k, v, mask, out, row_max, row_sum, g)),
                plain_ms=cuda_time_ms(lambda: plain_attention_backward(
                    q, k, v, mask, g)),
                library_ms=cuda_time_ms(lambda: torch.autograd.grad(
                    sdpa_out, leaves, g, retain_graph=True))),
                attention_bound_ms(B, H, L, backward=True,
                                   dtype="bfloat16"), BOUND_BASIS_K3_BF16)
            del sdpa_out, leaves
        else:
            t = with_bound(dict(
                ms=cuda_time_ms(lambda: cuda_attention.fused_attention(
                    q, k, v, mask)),
                plain_ms=cuda_time_ms(lambda: multi_head_attention(
                    q, k, v, mask)),
                library_ms=cuda_time_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=additive))),
                attention_bound_ms(B, H, L, dtype="bfloat16"),
                BOUND_BASIS_BF16)
        t["name"], t["shape"] = ("K3" if backward else "K1"), [B, H, L, 128]
        bf16_other.append(t)
        say(f"[timing] {t['name']} bfloat16 {t['shape']} (serving at "
            f"--dtype bfloat16 or tensor parallel at bfloat16): kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
            f"(bfloat16) {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.3e} ms ({t['bound_by']}) on {card}")

    lap("9 timings")
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
        with record_kernel_inputs() as train_inputs:
            _, _, final_step = train(pre_cfg, model_config, train_cfg,
                                     log=log, device=device, step_hook=hook)
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
        # the steps' and the validation pass's kernel inputs (its sample's
        # forward at batch 1 and collate's buckets) against the plain
        # versions, after the counts are read
        check_recorded_inputs(train_inputs, "train kernels", card)
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
            f"{sorted(set(per_step))}, in the validation pass {eval_counts}, "
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
        # the validation forward and the validation sample's forward
        if eval_counts != (20, 0, 20, 0):
            raise RuntimeError(f"launches in the validation pass "
                               f"{eval_counts}, expected 20 K1 + 20 K2 "
                               "(the losses' forward and the sample's)")
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

        lap("10 training")
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

        lap("11 synthesis from the checkpoint")
        # 12. reproducibility: REPRO_STEPS steps twice from one seed through
        #     train(), with no duty but the final checkpoint
        def trained_params(run, dtype=torch.float32):
            cfg = dict(train_cfg, path={
                k: os.path.join(tmp, f"repro{run}", k) for k in
                ("ckpt_path", "log_path", "result_path")})
            # scan_step 1: the per-step path (train.yaml's scan_step 500
            # would take scan mode here, K = REPRO_STEPS; the scan
            # sub-phase below holds its repro)
            cfg["step"] = dict(cfg["step"], total_step=REPRO_STEPS,
                               log_step=REPRO_STEPS, val_step=10 ** 9,
                               save_step=10 ** 9, scan_step=1)
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
            with contextlib.redirect_stdout(printed), \
                    record_kernel_inputs() as bf_inputs:
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
        check_recorded_inputs(bf_inputs, "train bf16 kernels", card)
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
        if bf_eval != dict(want, K1_bf16=20, K2_bf16=20):
            raise RuntimeError(f"launches in the bfloat16 validation pass "
                               f"{bf_eval}, expected 20 bfloat16 K1 + 20 "
                               "bfloat16 K2 (the losses' forward and the "
                               "sample's)")

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
        del first, second

        lap("12 repro")
        # the scan sub-phase: train.yaml's scan mode through the train CLI
        scanned = scan_training(device, card, tmp, pre_cfg, model_config,
                                train_cfg)
        lap("10 scan sub-phase")

    # 13. data preparation: align, preprocess, train with the duties and
    #     evaluate --synth on the tracked clips; 15. vocoder training on
    #     those features (before phase 14's line, which counts its launches)
    with tempfile.TemporaryDirectory() as prep_tmp:
        prep = data_preparation(device, card, prep_tmp)
        lap("13 data preparation")
        voc = vocoder_training(device, card, prep["features"], prep_tmp)
        lap("15 vocoder")
        # 16. serving and 17. objective evaluation (on phase 13's features)
        served = serving(device, card, prep_tmp)
        lap("16 serving")
        evaluated = evaluation(device, card, prep["features"], prep_tmp)
        lap("17 evaluate")
        # 18. parallel training, 19. serving replicas, 20. the G2P
        #     tooling, 21. leave-one-out and the vocoder ladder
        par = parallel_training(device, card, prep["features"], prep_tmp)
        lap("18 parallel")
        replicas = serving_replicas(device, card)
        lap("19 replicas")
        g2p_tooling(device, card, prep_tmp)
        lap("20 g2p")
        loo = leave_one_out(device, card, prep["features"], prep_tmp)
        lap("21 leave-one-out")
    path_launches = dict(prep["launches"], **voc["launches"],
                         **served["launches"], **evaluated["launches"],
                         **par["launches"], **replicas["launches"],
                         **loo["launches"], **scanned["launches"])

    # 14. kernels line
    sources = {"K1": ("fused_attention", "fastspeech2_tpu_torch/csrc/attention.cu",
                      "fastspeech2_tpu/ops/pallas_attention.py:93",
                      "[1, 2, 1000, 128] f32"),
               "K2": ("fused_conv_ffn",
                      "fastspeech2_tpu_torch/csrc/conv_ffn_f32.cu",
                      "fastspeech2_tpu/ops/pallas_ffn.py:61",
                      "[1, 1000, 256] -> 1024, k=(9, 1) f32"),
               "K3": ("fused_attention_backward",
                      "fastspeech2_tpu_torch/csrc/attention_bwd.cu",
                      "fastspeech2_tpu/ops/pallas_attention.py:138",
                      "[10, 2, 1000, 128] f32")}
    errs = {"K1": k1_err, "K2": k2_err, "K3": k3_err}
    # K1, K2 and K3 at every shape the paths give them
    keys = ("ms", "dev_ms", "prof_ms", "plain_ms", "library_ms",
            "library_dev_ms", "library_prof_ms", "bound_ms", "bound_by",
            "simt_bound_ms")
    per_shape = {name: [
        dict(shape=[B, 2, L, 128], **{key: t.get(key) for key in keys})
        for (B, L), t in sorted(
            [((B, L), t) for (n, B, L), t in timings.items() if n == name]
            + [((TRAIN_BATCH, L), t) for (n, L), t in train_timings.items()
               if n == name])]
        for name in ("K1", "K3")}
    per_shape["K2"] = [dict(shape=[B, L, 256], taps=t.get("taps", [9, 1]),
                            **{key: t.get(key) for key in keys})
                       for (n, B, L), t in sorted(timings.items())
                       + sorted(k2_taps3.items()) if n == "K2"]
    # ... and at serving's batch-16 shapes (phase 16)
    for name in ("K1", "K2"):
        per_shape[name] += [dict(shape=t["shape"],
                                 **{key: t.get(key) for key in keys})
                            for t in served["per_shape"][name]]
    # ... and at one head per rank under tensor parallel (phase 18)
    for name in ("K1", "K3"):
        per_shape[name] += [dict(shape=t["shape"],
                                 **{key: t.get(key) for key in keys})
                            for t in par["per_shape"][name]]
    # the float32 kernels' own sources (on wgmma and TMA)
    f32_sources = {
        "K1": ["fastspeech2_tpu_torch/csrc/attention.cu",
               "fastspeech2_tpu_torch/csrc/attention_f32.cuh",
               "fastspeech2_tpu_torch/csrc/attention_bf16.cuh",
               "fastspeech2_tpu_torch/csrc/attention_common.cuh",
               "fastspeech2_tpu_torch/csrc/hopper.cuh"],
        "K2": ["fastspeech2_tpu_torch/csrc/conv_ffn_f32.cu",
               "fastspeech2_tpu_torch/csrc/hopper.cuh",
               "fastspeech2_tpu_torch/csrc/conv_tiles.cuh"],
        "K3": ["fastspeech2_tpu_torch/csrc/attention_bwd.cu",
               "fastspeech2_tpu_torch/csrc/attention_f32.cuh",
               "fastspeech2_tpu_torch/csrc/attention_bf16.cuh",
               "fastspeech2_tpu_torch/csrc/attention_common.cuh",
               "fastspeech2_tpu_torch/csrc/hopper.cuh"]}
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
            **{key: t.get(key) for key in ("dev_ms", "prof_ms",
                                           "library_dev_ms",
                                           "library_prof_ms")},
            **({"sources": f32_sources[name],
                "instances": [r for r in wgmma_build
                              if r["kernel"].startswith(f"{name} f32")]}
               if name in f32_sources else {}),
            "per_shape": per_shape.get(name),
            "launches_by_path": {"synthesis": launches.get(name, 0),
                                 "parity synthesis": parity_launches.get(
                                     name, 0),
                                 **{path: n[name] for path, n in
                                    options["launches"].items()},
                                 "training": train_launches[name],
                                 **{path: n[name] for path, n in
                                    path_launches.items()}}})
    # K4: the sums over the 12 calls of one 1000-frame parity forward
    kernels.append({
        "name": "K4 fused_resblock", "route": "cuda",
        "source": "fastspeech2_tpu_torch/csrc/resblock.cu",
        "instances": k4_build,
        "replaces": "fastspeech2_tpu/ops/pallas_resblock.py:122",
        "launches": parity_launches["K4"], "max_abs_err": k4_err,
        "dtype": "float32",
        "ms": k4_total["ms"], "plain_ms": k4_total["plain_ms"],
        "bound_ms": k4_total["bound_ms"],
        "bound_by": "/".join(sorted({t["bound_by"] for t in k4_timings})),
        "library_ms": k4_total["library_ms"], "bound_basis": BOUND_BASIS,
        "simt_bound_ms": k4_total["simt_bound_ms"],
        "sources": ["fastspeech2_tpu_torch/csrc/resblock.cu",
                    "fastspeech2_tpu_torch/csrc/hopper.cuh"],
        "shape": "the 12 ResBlock calls of a 1000-frame parity forward, "
                 "[1, 256|128|64|32, 8000|64000|128000|256000], k = 3, 7, "
                 "11, f32",
        "per_call": k4_timings,
        "per_call_serving": served["per_shape"]["K4"],
        "launches_by_path": {"synthesis": launches["K4"],
                             "parity synthesis": parity_launches["K4"],
                             **{path: n["K4"] for path, n in
                                options["launches"].items()},
                             "training": train_launches["K4"],
                             **{path: n["K4"] for path, n in
                                path_launches.items()}}})
    # the bfloat16 instances: launches on the bfloat16 synthesis path (K1
    # and K2, one acoustic forward) and the bfloat16 training path (K3,
    # TRAIN_STEPS steps)
    bf_launches = {"K1": b_launches["K1_bf16"], "K2": b_launches["K2_bf16"],
                   "K3": sum(r["launches"]["K3_bf16"] for r in bf_steps)}
    # the bfloat16 attention kernels' own sources
    bf16_sources = {
        "K1": ["fastspeech2_tpu_torch/csrc/attention_bf16.cu",
               "fastspeech2_tpu_torch/csrc/attention_bf16.cuh",
               "fastspeech2_tpu_torch/csrc/hopper.cuh"],
        "K2": ["fastspeech2_tpu_torch/csrc/conv_ffn.cu",
               "fastspeech2_tpu_torch/csrc/hopper.cuh",
               "fastspeech2_tpu_torch/csrc/conv_tiles.cuh"],
        "K3": ["fastspeech2_tpu_torch/csrc/attention_bwd_bf16.cu",
               "fastspeech2_tpu_torch/csrc/attention_bf16.cuh",
               "fastspeech2_tpu_torch/csrc/hopper.cuh"]}
    for name in ("K1", "K2", "K3"):
        fn, src, replaces, shape = sources[name]
        if name in bf16_sources:
            src = bf16_sources[name][0]
        t = bf16_timings[(name, TRAIN_BATCH, 1000) if name == "K3"
                         else (name, 1, 1000)]
        per = [dict(shape=[B, 2, L, 128] if name != "K2" else [B, L, 256],
                    **{key: v.get(key) for key in keys})
               for (n, B, L), v in sorted(bf16_timings.items()) if n == name]
        per += [dict(shape=v["shape"], **{key: v.get(key) for key in keys})
                for v in bf16_other if v["name"] == name]
        if name == "K2":   # serving's shapes (phase 16)
            per += [dict(shape=v["shape"], **{key: v.get(key) for key in keys})
                    for v in served["per_shape"]["K2_bf16"]]
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
            **({"sources": bf16_sources[name]} if name in bf16_sources
               else {}),
            "instances": [r for r in wgmma_build
                          if r["kernel"].startswith(f"{name} bf16")],
            "launches_by_path": {
                "bf16 synthesis": b_launches[f"{name}_bf16"],
                "bf16 training": bf_totals[f"{name}_bf16"],
                **{path: n[f"{name}_bf16"] for path, n in
                   path_launches.items()}}})
    lap("14 kernels line")
    say(f"[total] the whole run took {time.perf_counter() - started:.1f} s "
        f"(ceiling {RUN_CEILING_S} s) on {card}; phases (wall s): "
        + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
