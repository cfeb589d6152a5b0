"""Single-utterance synthesis CLI (port of
``fastspeech2_tpu/cli/synthesize_cli.py``, single mode):

    python -m fastspeech2_tpu_torch.cli.synthesize_cli --mode single \\
        --text "The quick brown fox jumps over the lazy dog." \\
        --weights_npz weights/acoustic_LJSpeech10_100k.npz \\
        --vocoder_ckpt weights/vocoder_gen_mixed60k.npz \\
        -p config/LJSpeech10/preprocess.yaml \\
        -m config/LJSpeech10/model.yaml -t config/LJSpeech10/train.yaml

The acoustic weights come from a tracked npz snapshot (``--weights_npz``)
or from the port's own training checkpoint ``<ckpt_path>/<N>.pth.tar``
(``--restore_step N``, as the JAX CLI restores its own checkpoints).  The
vocoder is the one model.yaml names (``vocoder.model``): with
``-m config/LJSpeech/model.yaml`` the parity HiFi-GAN, whose ResBlocks run
K4 on the card; ``--vocoder_ckpt`` is optional (see ``get_vocoder``).

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given; asking for CUDA without a card raises.  Computes in float32 with
TF32 off for matrix products and cuDNN convolutions (the JAX CLI's default
is --dtype float32).  Batch mode (--source), --long and --torch_ckpt are
not ported yet.
"""

import argparse
import os

import numpy as np

from fastspeech2_tpu_torch.configs.config import (
    FastSpeech2Config,
    load_yaml_configs,
)
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
from fastspeech2_tpu_torch.synthesis.pipeline import Synthesizer
from fastspeech2_tpu_torch.synthesis.vocoder import get_vocoder, vocoder_infer
from fastspeech2_tpu_torch.training.checkpoint import load_checkpoint
from fastspeech2_tpu_torch.utils.device import resolve_device
from fastspeech2_tpu_torch.utils.params_io import (
    from_jax_params,
    load_variables_npz,
)


def load_model_for_inference(preprocess_config, model_config, weights_npz,
                             device, train_config=None, restore_step=0):
    """FastSpeech2 in eval mode on ``device`` with a tracked npz snapshot's
    weights, or with the weights of the port's checkpoint of
    ``restore_step`` under train_config's ckpt_path -> (model, config)."""
    cfg = FastSpeech2Config.build(preprocess_config, model_config)
    model = FastSpeech2(cfg)
    if restore_step:
        state = load_checkpoint(train_config["path"]["ckpt_path"],
                                restore_step)["model"]
    else:
        state = from_jax_params(load_variables_npz(weights_npz), cfg)
    model.load_state_dict(state)
    return model.to(device).eval(), cfg


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mode", choices=["single"], required=True)
    parser.add_argument("--text", type=str, required=True,
                        help="raw text to synthesize")
    parser.add_argument("--speaker_id", type=int, default=0)
    parser.add_argument("-p", "--preprocess_config", required=True)
    parser.add_argument("-m", "--model_config", required=True)
    parser.add_argument("-t", "--train_config", required=True)
    parser.add_argument("--pitch_control", type=float, default=1.0)
    parser.add_argument("--energy_control", type=float, default=1.0)
    parser.add_argument("--duration_control", type=float, default=1.0)
    parser.add_argument("--control_mode", default="reference",
                        choices=("reference", "absolute"))
    weights = parser.add_mutually_exclusive_group(required=True)
    weights.add_argument("--weights_npz",
                         help="acoustic weights (tracked fp16 npz snapshot)")
    weights.add_argument("--restore_step", type=int,
                         help="acoustic weights from the port's training "
                              "checkpoint <ckpt_path>/<N>.pth.tar")
    parser.add_argument("--vocoder_ckpt", default=None,
                        help="vocoder weights: a tracked fp16 npz snapshot "
                             "or a reference .pth.tar (default: "
                             "configs/hifigan/generator_<speaker>.pth.tar "
                             "for HiFi-GAN where it exists, else a seeded "
                             "random init)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--result_path", default=None,
                        help="output directory (default: train.yaml "
                             "path.result_path)")
    return parser


def main(argv=None):
    """-> (list of int16 wavs, FastSpeech2Output, list of written wav
    paths)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    preprocess_config, model_config, train_config = load_yaml_configs(
        args.preprocess_config, args.model_config, args.train_config)
    model, cfg = load_model_for_inference(
        preprocess_config, model_config, args.weights_npz, device,
        train_config=train_config, restore_step=args.restore_step)
    vocoder = get_vocoder(model_config, args.vocoder_ckpt, device)
    synthesizer = Synthesizer(model, cfg, preprocess_config, device,
                              vocoder=vocoder,
                              control_mode=args.control_mode)
    result_path = args.result_path or train_config["path"]["result_path"]

    ids_seq, phones = synthesizer.text_to_ids(args.text)
    print(f"Raw Text Sequence: {args.text}")
    print(f"Phoneme Sequence: {phones}")
    out = synthesizer.infer_ids([ids_seq], np.array([args.speaker_id]),
                                args.pitch_control, args.energy_control,
                                args.duration_control)
    wavs = vocoder_infer(out.postnet_mel, vocoder, preprocess_config,
                         lengths=out.mel_len.cpu().numpy())[:1]
    paths = synthesizer.save_results([args.text[:100]], wavs, result_path)
    print(f"Results written to {os.path.dirname(paths[0])}")
    return wavs, out, paths


if __name__ == "__main__":
    main()
