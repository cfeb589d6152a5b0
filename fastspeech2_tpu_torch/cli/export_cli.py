"""Export CLI (port of ``fastspeech2_tpu/cli/export_cli.py``): a port
checkpoint -> the upstream reference's ``.pth.tar`` layout.

    python -m fastspeech2_tpu_torch.cli.export_cli --restore_step N \\
        -p PRE.yaml -m MODEL.yaml -t TRAIN.yaml -o acoustic.pth.tar
    python -m fastspeech2_tpu_torch.cli.export_cli \\
        --vocoder_ckpt OUT_DIR/N.pth.tar -o generator.pth.tar

The acoustic export writes ``{"model": state_dict, "optimizer": {}}`` from
the acoustic checkpoint ``<ckpt_path>/<N>.pth.tar``, with the buffers the
reference registers and the port derives from the config (the position
tables, the pitch and energy bins) put back, as
``fastspeech2_tpu/convert/to_torch.py:139-148`` writes it; the synthesize
CLI's ``--torch_ckpt`` reads it.  The vocoder export reads the
vocoder trainer's checkpoint (generator, discriminators, both optimizers)
and writes the lean ``{"generator": state_dict}`` of
``convert/to_torch.py:184-196``, which ``get_vocoder`` reads.  Runs on the
CPU: it only moves tensors.
"""

import argparse
import os

import torch

from fastspeech2_tpu_torch.configs.config import (
    FastSpeech2Config,
    load_yaml_configs,
)
from fastspeech2_tpu_torch.models.variance import _make_bins
from fastspeech2_tpu_torch.ops.positional import sinusoid_position_encoding
from fastspeech2_tpu_torch.synthesis.vocoder import read_torch_checkpoint
from fastspeech2_tpu_torch.training.checkpoint import load_checkpoint


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--restore_step", type=int, default=None)
    parser.add_argument("-p", "--preprocess_config", default=None)
    parser.add_argument("-m", "--model_config", default=None)
    parser.add_argument("-t", "--train_config", default=None)
    parser.add_argument("-o", "--output", required=True,
                        help="output .pth.tar path")
    parser.add_argument("--vocoder_ckpt", default=None,
                        help="export a VOCODER instead: a checkpoint of "
                             "train_vocoder_cli (<out_dir>/<step>.pth.tar) "
                             '-> a lean {"generator": ...} .pth.tar')
    return parser


def acoustic_state_dict(model_state, cfg):
    """A port checkpoint's model state_dict -> the reference's: the
    sinusoid tables ``encoder.position_enc`` and ``decoder.position_enc``
    ([1, max_seq_len + 1, hidden]) and the pitch and energy bins added."""
    sd = dict(model_state)
    for name, hidden in (("encoder", cfg.encoder_hidden),
                         ("decoder", cfg.decoder_hidden)):
        sd[f"{name}.position_enc"] = sinusoid_position_encoding(
            cfg.max_seq_len + 1, hidden)[None]
    for name in ("pitch", "energy"):
        sd[f"variance_adaptor.{name}_bins"] = _make_bins(
            getattr(cfg, f"{name}_min"), getattr(cfg, f"{name}_max"),
            cfg.n_bins, getattr(cfg, f"{name}_quantization"))
    return sd


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.vocoder_ckpt:
        return export_vocoder(args.vocoder_ckpt, args.output)
    if args.restore_step is None:
        parser.error("--restore_step is required for acoustic export")
    if not (args.preprocess_config and args.model_config
            and args.train_config):
        parser.error("acoustic export requires -p/-m/-t config files")
    preprocess_config, model_config, train_config = load_yaml_configs(
        args.preprocess_config, args.model_config, args.train_config)
    cfg = FastSpeech2Config.build(preprocess_config, model_config)
    state = load_checkpoint(train_config["path"]["ckpt_path"],
                            args.restore_step)
    torch.save({"model": acoustic_state_dict(state["model"], cfg),
                "optimizer": {}}, args.output)
    print(f"Exported step {args.restore_step} to {args.output}")
    return args.output


def export_vocoder(ckpt_path, output):
    """The generator of a vocoder train-state checkpoint -> ``output`` as
    ``{"generator": state_dict}``, with the JAX CLI's topology note for a
    generator the reference's fixed 4-stage parity Generator cannot
    load."""
    ckpt = read_torch_checkpoint(ckpt_path)
    sd = {k: v.float() for k, v in ckpt["generator"].items()}
    torch.save({"generator": sd}, output)
    config = ckpt.get("generator_config", {})
    size = os.path.getsize(output) / 1e6
    if config.get("arch") == "melgan":
        note = (" (MelGAN topology: loadable by this package's get_vocoder "
                "with vocoder.model MelGAN; NOT by the reference's HiFi-GAN "
                "Generator)")
    else:
        n_ups = sum(1 for k in sd if k.startswith("ups.")
                    and k.endswith(".weight"))
        post_ch = sd["conv_post.weight"].shape[0]
        note = ("" if n_ups == 4 and post_ch == 1 else
                " (iSTFT-variant topology: loadable by this package's "
                "get_vocoder with the matching config; NOT by the "
                "reference, whose Generator is the fixed 4-stage parity "
                "layout)")
    print(f"Exported generator from {ckpt_path} to {output} "
          f"({size:.0f} MB){note}")
    return output


if __name__ == "__main__":
    main()
