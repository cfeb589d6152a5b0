"""Synthesis CLI (port of ``fastspeech2_tpu/cli/synthesize_cli.py``):

    python -m fastspeech2_tpu_torch.cli.synthesize_cli --mode single \\
        --text "The quick brown fox jumps over the lazy dog." \\
        --weights_npz weights/acoustic_LJSpeech10_100k.npz \\
        --vocoder_ckpt weights/vocoder_gen_mixed60k.npz \\
        -p config/LJSpeech10/preprocess.yaml \\
        -m config/LJSpeech10/model.yaml -t config/LJSpeech10/train.yaml

Modes, as in the JAX CLI:

- ``--mode single --text T``: one utterance -> ``<T[:100]>.wav`` and
  ``.png`` (the png needs matplotlib);
- ``--mode single --long --text T``: split into sentences, synthesized as
  one batch and joined with 120 ms pauses -> ``<T[:40]>.wav``;
- ``--mode batch --source METADATA``: the rows of a train.txt-style file
  (``basename|speaker|{phones}|raw text``), 8 per forward ->
  ``<basename>.wav`` and ``.png`` each.

The acoustic weights come from a tracked npz snapshot (``--weights_npz``),
from the port's own training checkpoint ``<ckpt_path>/<N>.pth.tar``
(``--restore_step N``) or from a reference-format FastSpeech 2
``.pth.tar`` (``--torch_ckpt``).  The vocoder is the one model.yaml names
(``vocoder.model``, see ``get_vocoder``): the HiFi-GAN generators (their
ResBlocks run K4 on the card), MelGAN, or Griffin-Lim for any other name;
``--vocoder_ckpt`` is optional.  The text frontend is English, or
Mandarin tone-numbered pinyin for a ``language: zh`` preprocess config.

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given; asking for CUDA without a card raises.  The acoustic model
computes at ``--dtype`` (float32 by default, as in the JAX CLI, or
bfloat16), with TF32 off for float32 matrix products and cuDNN
convolutions; the vocoder stays float32 and reads the mel upcast.
"""

import argparse
import json
import os

import numpy as np
import torch

from fastspeech2_tpu_torch.cli.common import add_dtype_arg, dtype_from_flag
from fastspeech2_tpu_torch.configs.config import (
    FastSpeech2Config,
    load_yaml_configs,
)
from fastspeech2_tpu_torch.data.dataset import FeatureDataset
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
from fastspeech2_tpu_torch.synthesis.pipeline import Synthesizer, write_wav
from fastspeech2_tpu_torch.synthesis.vocoder import get_vocoder, vocoder_infer
from fastspeech2_tpu_torch.text import text_to_sequence
from fastspeech2_tpu_torch.training.checkpoint import load_checkpoint
from fastspeech2_tpu_torch.utils.device import resolve_device
from fastspeech2_tpu_torch.utils.params_io import (
    fastspeech2_from_torch_state_dict,
    from_jax_params,
    load_variables_npz,
)

BATCH_SIZE = 8   # rows per forward in batch mode, as upstream


def load_model_for_inference(preprocess_config, model_config, weights_npz,
                             device, train_config=None, restore_step=0,
                             torch_ckpt=None, dtype=torch.float32):
    """FastSpeech2 in eval mode on ``device`` at the compute ``dtype`` with
    the weights of a tracked npz snapshot, of the port's checkpoint of
    ``restore_step`` under train_config's ckpt_path, or of a
    reference-format ``.pth.tar`` (``{"model": state_dict, ...}`` or a bare
    state_dict) -> (model, config)."""
    cfg = FastSpeech2Config.build(preprocess_config, model_config)
    model = FastSpeech2(cfg, dtype=dtype)
    if restore_step:
        state = load_checkpoint(train_config["path"]["ckpt_path"],
                                restore_step)["model"]
    elif torch_ckpt:
        ckpt = torch.load(torch_ckpt, map_location="cpu", weights_only=True)
        state = fastspeech2_from_torch_state_dict(ckpt.get("model", ckpt),
                                                  cfg)
    else:
        state = from_jax_params(load_variables_npz(weights_npz), cfg)
    model.load_state_dict(state)
    return model.to(device).eval(), cfg


def add_weights_args(parser):
    """The acoustic weights: exactly one of --weights_npz, --restore_step
    and --torch_ckpt."""
    weights = parser.add_mutually_exclusive_group(required=True)
    weights.add_argument("--weights_npz",
                         help="acoustic weights (tracked fp16 npz snapshot)")
    weights.add_argument("--restore_step", type=int,
                         help="acoustic weights from the port's training "
                              "checkpoint <ckpt_path>/<N>.pth.tar")
    weights.add_argument("--torch_ckpt",
                         help="acoustic weights from a reference-format "
                              "FastSpeech 2 .pth.tar")


def load_metadata_rows(preprocess_config, source_path):
    """A pipe-delimited metadata file (train.txt/val.txt schema) and the
    corpus speaker map -> (names, speaker_ids, phone_strings)
    (``fastspeech2_tpu/cli/common.py:81-99``)."""
    names, speakers, texts, _ = FeatureDataset._read_metadata(source_path)
    speakers_path = os.path.join(
        preprocess_config["path"]["preprocessed_path"], "speakers.json")
    speaker_map = {}
    if os.path.exists(speakers_path):
        with open(speakers_path) as f:
            speaker_map = json.load(f)
    speaker_ids = [speaker_map.get(s, 0) for s in speakers]
    return names, speaker_ids, texts


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mode", choices=["batch", "single"], required=True)
    parser.add_argument("--source", type=str, default=None,
                        help="batch mode: metadata file of phone strings")
    parser.add_argument("--text", type=str, default=None,
                        help="single mode: raw text to synthesize")
    parser.add_argument("--long", action="store_true",
                        help="single mode: no 100-char truncation; split "
                             "into sentences and join the audio")
    parser.add_argument("--speaker_id", type=int, default=0)
    parser.add_argument("-p", "--preprocess_config", required=True)
    parser.add_argument("-m", "--model_config", required=True)
    parser.add_argument("-t", "--train_config", required=True)
    parser.add_argument("--pitch_control", type=float, default=1.0)
    parser.add_argument("--energy_control", type=float, default=1.0)
    parser.add_argument("--duration_control", type=float, default=1.0)
    parser.add_argument("--control_mode", default="reference",
                        choices=("reference", "absolute"))
    add_weights_args(parser)
    parser.add_argument("--vocoder_ckpt", default=None,
                        help="vocoder weights: a tracked fp16 npz snapshot "
                             "or a reference .pth.tar (default: "
                             "configs/hifigan/generator_<speaker>.pth.tar "
                             "for HiFi-GAN where it exists, else a seeded "
                             "random init; Griffin-Lim takes none)")
    add_dtype_arg(parser, "float32")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--result_path", default=None,
                        help="output directory (default: train.yaml "
                             "path.result_path)")
    return parser


def main(argv=None):
    """Single mode -> (list of one int16 wav, FastSpeech2Output, [wav
    path]); --long -> ([the joined wav], list of chunks, [wav path]); batch
    mode -> (every row's wav, the FastSpeech2Output of each forward, the
    rows' wav paths)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.mode == "batch" and (args.source is None or args.text is not None
                                 or args.long):
        parser.error("--mode batch takes --source and no --text or --long")
    if args.mode == "single" and (args.text is None
                                  or args.source is not None):
        parser.error("--mode single takes --text and no --source")
    device = resolve_device(args.device)
    preprocess_config, model_config, train_config = load_yaml_configs(
        args.preprocess_config, args.model_config, args.train_config)
    model, cfg = load_model_for_inference(
        preprocess_config, model_config, args.weights_npz, device,
        train_config=train_config, restore_step=args.restore_step,
        torch_ckpt=args.torch_ckpt, dtype=dtype_from_flag(args.dtype))
    vocoder = get_vocoder(model_config, preprocess_config, args.vocoder_ckpt,
                          device)
    synthesizer = Synthesizer(model, cfg, preprocess_config, device,
                              vocoder=vocoder,
                              control_mode=args.control_mode)
    result_path = args.result_path or train_config["path"]["result_path"]
    controls = (args.pitch_control, args.energy_control,
                args.duration_control)

    if args.long:
        wav, chunks = synthesizer.synthesize_long(
            args.text, args.speaker_id, *controls)
        os.makedirs(result_path, exist_ok=True)
        path = os.path.join(result_path, f"{args.text[:40]}.wav")
        write_wav(path, preprocess_config["preprocessing"]["audio"][
            "sampling_rate"], wav)
        print(f"Synthesized {len(chunks)} chunks -> {path}")
        return [wav], chunks, [path]

    if args.mode == "single":
        ids_seq, phones = synthesizer.text_to_ids(args.text)
        print(f"Raw Text Sequence: {args.text}")
        print(f"Phoneme Sequence: {phones}")
        out = synthesizer.infer_ids([ids_seq], np.array([args.speaker_id]),
                                    *controls)
        wavs = vocoder_infer(out.postnet_mel, vocoder, preprocess_config,
                             lengths=out.mel_len.cpu().numpy())[:1]
        paths = synthesizer.save_results([args.text[:100]], out, wavs,
                                         result_path)
        print(f"Results written to {result_path}")
        return wavs, out, paths

    names, speaker_ids, texts = load_metadata_rows(preprocess_config,
                                                   args.source)
    cleaners = preprocess_config["preprocessing"]["text"]["text_cleaners"]
    all_wavs, outs, paths = [], [], []
    for start in range(0, len(names), BATCH_SIZE):
        rows = slice(start, start + BATCH_SIZE)
        id_seqs = [np.asarray(text_to_sequence(t, cleaners), np.int64)
                   for t in texts[rows]]
        out = synthesizer.infer_ids(id_seqs, speaker_ids[rows], *controls)
        # the batch-bucket padding rows are dropped (see _pack_batch)
        wavs = vocoder_infer(out.postnet_mel, vocoder, preprocess_config,
                             lengths=out.mel_len.cpu().numpy()
                             )[: len(id_seqs)]
        paths += synthesizer.save_results(names[rows], out, wavs,
                                          result_path)
        all_wavs += wavs
        outs.append(out)
    print(f"Results written to {result_path}")
    return all_wavs, outs, paths


if __name__ == "__main__":
    main()
