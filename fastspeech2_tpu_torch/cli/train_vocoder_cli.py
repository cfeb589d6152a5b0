"""Vocoder training CLI (port of ``fastspeech2_tpu/cli/train_vocoder_cli.py``):

    python -m fastspeech2_tpu_torch.cli.train_vocoder_cli \\
        --finetune_from preprocessed_data/LJSpeech10 --mel_source mixed \\
        --config fastspeech2_tpu_torch/configs/hifigan/config_istft.json \\
        --init_gen_npz weights/vocoder_gen_mixed60k.npz --mel_weight 135 \\
        --out_dir output/vocoder [--total_steps N] [--device cpu]

or from raw audio, ``--wav_dir DIR`` (<DIR>/<speaker>/*.wav).  The flags
and their defaults are the JAX CLI's; ``--config`` takes the upstream
hifigan config.json schema (generator topology, ``arch: melgan``,
``learning_rate``, ``lr_decay``, ``batch_size``, ``segment_size``,
``num_mels``, ``fmax``, a ``discriminator`` block), and the flags override
it.  Prints ``Vocoder step i/N: disc=..., gen=..., gen_adv=..., gen_fm=...,
gen_mel=...`` every ``--log_step`` steps and writes
``<out_dir>/<step>.pth.tar`` every ``--save_step`` steps; a rerun on the
same ``--out_dir`` resumes from the newest checkpoint.  Runs on the card
(``--device cuda``, the default) unless ``--device cpu`` is given, in
float32 with TF32 off.  ``--data_parallel N`` splits each batch over N
ranks, one process per card under ``torchrun --nproc_per_node N`` (each
on ``cuda:<LOCAL_RANK>``, NCCL; gloo with ``--device cpu``); it raises
unless the world has N ranks and N divides the batch.
"""

import argparse
import json

from fastspeech2_tpu_torch.parallel.mesh import init_from_torchrun
from fastspeech2_tpu_torch.synthesis.vocoder import GENERATOR_KEYS
from fastspeech2_tpu_torch.training import vocoder
from fastspeech2_tpu_torch.utils.device import resolve_device
from fastspeech2_tpu_torch.utils.params_io import load_variables_npz


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--wav_dir", default=None,
                   help="directory tree of training .wav files "
                        "(from-scratch mode)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--finetune_from", default=None,
                   help="preprocessed corpus path: fine-tune on aligned "
                        "(GT wav, mel) pairs (needs save_trimmed_wav at "
                        "preprocess time; 'pred' mels from export_mels_cli)")
    p.add_argument("--mel_source",
                   choices=["pred", "gt", "mixed", "gt_wav"],
                   default="pred",
                   help="mel inputs for --finetune_from: acoustic-model "
                        "predictions (pred), ground truth (gt), a 50/50 "
                        "per-sample mix (mixed), or gt_wav: the trimmed "
                        "wavs with the input mel computed in the step "
                        "(required for --aug_speed)")
    p.add_argument("--split", default=None, metavar="FILE",
                   help="with --finetune_from: train only on the "
                        "utterances this metadata file in the corpus names "
                        "(e.g. train.txt)")
    p.add_argument("--config", default=None,
                   help="hifigan config.json (upstream schema)")
    p.add_argument("--total_steps", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--segment_size", type=int, default=None)
    p.add_argument("--log_step", type=int, default=100)
    p.add_argument("--save_step", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_parallel", type=int, default=None,
                   help="split the segment batch over N ranks (run "
                        "under torchrun --nproc_per_node N)")
    p.add_argument("--adv_warmup", type=int, default=0,
                   help="hold the discriminators and train the generator "
                        "on mel-L1 only for the first N steps")
    p.add_argument("--learning_rate", type=float, default=None,
                   help="override the config learning rate (both "
                        "generator and discriminators)")
    p.add_argument("--mel_weight", type=float, default=None,
                   help="generator mel-L1 loss weight (default 45, "
                        "upstream HiFi-GAN)")
    p.add_argument("--init_gen_npz", default=None, metavar="NPZ",
                   help="warm-start the generator from a tracked fp16 npz "
                        "snapshot; ignored when out_dir already holds a "
                        "checkpoint (resume wins)")
    p.add_argument("--scan_step", type=int, default=1,
                   help="run K GAN steps per dispatch over a "
                        "device-resident corpus bank (K = gcd(scan_step, "
                        "log_step, save_step))")
    p.add_argument("--aug_gain_db", type=float, default=0.0,
                   help="random per-segment gain in U[-d, +d] dB")
    p.add_argument("--aug_speed", default=None, metavar="LO,HI",
                   help="random per-segment playback rate in U[lo, hi] "
                        "(needs in-graph mels: --wav_dir or --mel_source "
                        "gt_wav)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    """-> the ``training.vocoder.VocoderTrainState`` at the end."""
    p = build_parser()
    args = p.parse_args(argv)
    if args.wav_dir is None and args.finetune_from is None:
        p.error("one of --wav_dir or --finetune_from is required")

    cfg = {}
    if args.config:
        with open(args.config) as f:
            cfg = json.load(f)
    # the generator's keys, as the JAX CLI maps them (``:99-120``)
    gen_cfg = {k: cfg[k] for k in GENERATOR_KEYS if k in cfg}

    init_gen = None
    if args.init_gen_npz:
        loaded = load_variables_npz(args.init_gen_npz)
        if not isinstance(loaded, dict) or "params" not in loaded:
            raise SystemExit(
                f"--init_gen_npz {args.init_gen_npz}: snapshot has no "
                f"'params' collection (top-level keys: "
                f"{sorted(loaded) if isinstance(loaded, dict) else type(loaded).__name__}). "
                "Expected the {'params': ...} layout written by "
                "scripts/save_weights_npz.py.")
        init_gen = loaded["params"]

    return vocoder.train_vocoder(
        args.wav_dir, args.out_dir,
        total_steps=args.total_steps or cfg.get("training_steps", 1000),
        batch_size=args.batch_size or cfg.get("batch_size", 16),
        segment_size=args.segment_size or cfg.get("segment_size", 8192),
        sampling_rate=cfg.get("sampling_rate", 22050),
        learning_rate=(args.learning_rate
                       if args.learning_rate is not None
                       else cfg.get("learning_rate", 2e-4)),
        lr_decay=cfg.get("lr_decay", 0.999),
        n_mel_channels=cfg.get("num_mels", 80),
        mel_fmax=cfg.get("fmax", 8000.0) or 8000.0,
        generator_config=gen_cfg or None,
        discriminator_config=cfg.get("discriminator"),
        finetune_from=args.finetune_from,
        mel_source=args.mel_source, split=args.split,
        init_generator_params=init_gen,
        data_parallel=args.data_parallel, scan_step=args.scan_step,
        mel_weight=(args.mel_weight if args.mel_weight is not None
                    else cfg.get("mel_weight", 45.0)),
        adv_warmup=args.adv_warmup,
        aug_gain_db=args.aug_gain_db,
        aug_speed=(tuple(float(x) for x in args.aug_speed.split(","))
                   if args.aug_speed else None),
        log_step=args.log_step, save_step=args.save_step, seed=args.seed,
        device=init_from_torchrun(resolve_device(args.device)))


if __name__ == "__main__":
    main()
