"""Where the time of one training step goes, on the card:

    python -m fastspeech2_tpu_torch.tools.profile_train [--steps 5] \
        [--dtype float32|bfloat16]

Trains at full model width (``config/LJSpeech10/model.yaml``, train.yaml's
optimizer, batch 10) on the synthetic corpus ``chip_smoke.py`` trains on
(30 utterances of 60-120 phones, 10 held out; text bucket 128, mel bucket
1024: encoder L 128, decoder L 1000) at the compute ``--dtype``
(parameters float32), warms up 3 steps, then traces
``--steps`` steps with ``torch.profiler`` and prints: the host time per
step with the profiler off and on, the device's busy share (the sum of
kernel times over the traced window's wall time; one stream), the kernel
time by group (K1, K3, cuDNN convolutions, cuBLAS GEMMs, the rest), and
the top kernels.  Raises without a card.
"""

import argparse
import collections
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from fastspeech2_tpu_torch.configs.config import load_yaml_configs
from fastspeech2_tpu_torch.data.dataset import BucketedLoader, FeatureDataset
from fastspeech2_tpu_torch.data.synthetic import (
    generate_corpus,
    synthetic_preprocess_config,
)
from fastspeech2_tpu_torch.training.loop import init_training
from fastspeech2_tpu_torch.training.step import batch_to_device, train_step
from fastspeech2_tpu_torch.utils.device import resolve_device

CONFIG = "config/LJSpeech10"
GROUPS = (("K1 attention forward", ("mha_fwd",)),
          ("K3 attention backward", ("mha_bwd",)),
          ("K2 conv FFN", ("ffn_",)),
          ("cuDNN convolutions", ("conv", "cudnn", "implicit", "dgrad",
                                  "wgrad", "xmma")),
          ("cuBLAS GEMMs", ("gemm", "cutlass", "sm90_", "ampere_")))


def group_of(name):
    lower = name.lower()
    for group, keys in GROUPS:
        if any(k in lower for k in keys):
            return group
    return "other (elementwise, reductions, copies, optimizer)"


def init_synthetic_training(device, dtype=torch.float32):
    """-> (model in train mode at the compute ``dtype``, optim_cfg,
    optimizer, the first epoch's batches on ``device``), at full width on
    the synthetic corpus."""
    _, model_config, train_config = load_yaml_configs(
        f"{CONFIG}/preprocess.yaml", f"{CONFIG}/model.yaml",
        f"{CONFIG}/train.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        generate_corpus(tmp, n_utterances=30, min_phones=60, max_phones=120,
                        n_mels=80, seed=5, val_size=10)
        pre = synthetic_preprocess_config(tmp, n_mels=80)
        model, cfg, optim_cfg, optimizer = init_training(
            pre, model_config, train_config, device=device, dtype=dtype)
        loader = BucketedLoader(
            FeatureDataset("train.txt", pre), batch_size=optim_cfg.batch_size,
            group_size=4, shuffle=True, drop_last=True,
            max_mel_len=cfg.max_seq_len, text_bucket=128, mel_bucket=1024)
        batches = [batch_to_device(b, device) for b in loader.epoch(0)]
    return model.train(), optim_cfg, optimizer, batches


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                        default="float32")
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    card = torch.cuda.get_device_name(0)
    model, optim_cfg, optimizer, batches = init_synthetic_training(
        device, getattr(torch, args.dtype))
    step = 0

    def run(n):
        nonlocal step
        for _ in range(n):
            train_step(model, optimizer, batches[step % len(batches)], step)
            step += 1
        torch.cuda.synchronize()

    run(3)
    t0 = time.perf_counter()
    run(args.steps)
    plain_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(args.steps)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_group = collections.Counter()
    for e in kernels:
        by_group[group_of(e.key)] += e.self_device_time_total / 1e3
    kernel_ms = total_ms / args.steps
    print(f"[profile] {args.steps} train steps at batch "
          f"{optim_cfg.batch_size}, {args.dtype}: {plain_ms:.2f} ms per step (host clock, "
          f"profiler off), {wall_ms / args.steps:.2f} ms with it on; "
          f"kernels {kernel_ms:.2f} ms per step; device busy "
          f"{100 * kernel_ms / plain_ms:.1f}% of a step without the "
          f"profiler, {100 * total_ms / wall_ms:.1f}% with it; on {card}",
          flush=True)
    for group, ms in by_group.most_common():
        print(f"[profile] {group}: {ms / args.steps:.2f} ms per step, "
              f"{100 * ms / total_ms:.1f}% of kernel time", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"[profile]   {e.self_device_time_total / 1e3 / args.steps:8.3f}"
              f" ms/step  {e.count // args.steps:5d} calls/step  "
              f"{e.key[:110]}", flush=True)


if __name__ == "__main__":
    main()
