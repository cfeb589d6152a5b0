"""Validation-set evaluation CLI (port of
``fastspeech2_tpu/cli/evaluate_cli.py``, its loss mode):

    python -m fastspeech2_tpu_torch.cli.evaluate_cli -p PRE.yaml \\
        -m MODEL.yaml -t TRAIN.yaml \\
        (--restore_step N | --weights_npz F | --torch_ckpt F) \\
        [--synth] [--objective N [--split val|train] [--save_dir D]] \\
        [--vocoder_ckpt F] [--dtype float32|bfloat16] [--device cuda|cpu]

Prints the sample-weighted mean teacher-forced losses over val.txt in eval
mode (the loader's duplicate rows left out), one "Validation Step" line,
from the port's own checkpoint ``<ckpt_path>/<N>.pth.tar``, a tracked
npz snapshot or a reference-format ``.pth.tar``.  Runs on the card unless
``--device cpu`` is given, at the compute ``--dtype`` (float32 by
default, as in the JAX CLI).  ``--synth`` also writes the first
validation utterance's synthesized sample to result_path, as the training
loop's duty makes it: ``val_step_<N>.png`` (where matplotlib is
installed) and, through model.yaml's vocoder (``--vocoder_ckpt`` or its
seeded init), ``val_step_<N>_{reconstructed,synthesized}.wav``.
``--objective N`` synthesizes N utterances of the ``--split`` metadata
from their phone strings, text -> wav through model.yaml's vocoder, and
scores each against its trimmed ground-truth wav
(``<preprocessed_path>/wav/<speaker>-wav-<name>.npy``, written by a
preprocess with ``save_trimmed_wav``): DTW mel-cepstral distortion, the
duration ratio, F0 RMSE and voicing F1 (``evaluation/metrics.py``), one
JSON line each and their mean; ``--save_dir`` also receives
``<name>_tts.wav`` and a ``metrics.json`` for
``evaluation/demo_page.py``.
"""

import argparse
import os

from fastspeech2_tpu_torch.cli.common import add_dtype_arg, dtype_from_flag
from fastspeech2_tpu_torch.cli.synthesize_cli import (
    add_weights_args,
    load_metadata_rows,
    load_model_for_inference,
)
from fastspeech2_tpu_torch.configs.config import (
    OptimConfig,
    load_yaml_configs,
)
from fastspeech2_tpu_torch.data.dataset import FeatureDataset
from fastspeech2_tpu_torch.training.loop import evaluate, loss_line
from fastspeech2_tpu_torch.utils.device import resolve_device


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-p", "--preprocess_config", required=True)
    parser.add_argument("-m", "--model_config", required=True)
    parser.add_argument("-t", "--train_config", required=True)
    add_weights_args(parser)
    add_dtype_arg(parser, "float32")
    parser.add_argument("--synth", action="store_true",
                        help="also write a synth-sample figure and wavs to "
                             "result_path, like the in-loop duty")
    parser.add_argument("--objective", type=int, default=0, metavar="N",
                        help="also synthesize N utterances end to end and "
                             "report objective metrics (DTW MCD, duration "
                             "ratio, F0 RMSE, voicing F1) against the "
                             "ground-truth wavs; needs a corpus "
                             "preprocessed with save_trimmed_wav: true")
    parser.add_argument("--split", choices=["val", "train"], default="val",
                        help="metadata split for --objective")
    parser.add_argument("--save_dir", default=None,
                        help="with --objective: also write each "
                             "synthesized wav plus a metrics.json there")
    parser.add_argument("--vocoder_ckpt", default=None,
                        help="vocoder weights for --synth and --objective "
                             "(npz or .pth.tar)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None):
    """-> the six mean validation losses."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    preprocess_config, model_config, train_config = load_yaml_configs(
        args.preprocess_config, args.model_config, args.train_config)
    model, cfg = load_model_for_inference(
        preprocess_config, model_config, args.weights_npz, device,
        train_config=train_config, restore_step=args.restore_step,
        torch_ckpt=args.torch_ckpt, dtype=dtype_from_flag(args.dtype))
    val_dataset = FeatureDataset("val.txt", preprocess_config)
    losses = evaluate(model, val_dataset,
                      OptimConfig.build(train_config).batch_size, cfg,
                      device)
    print(loss_line(f"Validation Step {args.restore_step or 0}", losses))
    if args.synth:
        write_synth_sample(args, preprocess_config, model_config,
                           train_config, model, cfg, val_dataset, device)
    if args.objective:
        objective_eval(args, preprocess_config, model_config, model, cfg,
                       device)
    return losses


def objective_eval(args, preprocess_config, model_config, model, cfg,
                   device):
    """Text -> wav for ``args.objective`` utterances of the split, scored
    against ground truth (fastspeech2_tpu/cli/evaluate_cli.py:111-210) ->
    the rows, or None when there is nothing to score.

    The metadata's phone strings are used (no G2P noise).  Durations
    diverge between prediction and ground truth, so the comparison is
    DTW-aligned MCD plus the synthesized/GT duration ratio; the F0 metrics
    are frame-aligned over the shorter of the two."""
    import json

    import numpy as np

    from fastspeech2_tpu_torch.evaluation.metrics import f0_metrics, mcd
    from fastspeech2_tpu_torch.synthesis.pipeline import Synthesizer
    from fastspeech2_tpu_torch.synthesis.vocoder import (
        get_vocoder,
        vocoder_infer,
    )
    from fastspeech2_tpu_torch.text import text_to_sequence

    pp = preprocess_config["preprocessing"]
    pre_path = preprocess_config["path"]["preprocessed_path"]
    wav_dir = os.path.join(pre_path, "wav")
    if not os.path.isdir(wav_dir):
        print("--objective needs trimmed GT wavs: re-preprocess with "
              "preprocessing.audio.save_trimmed_wav: true")
        return None
    vocoder = get_vocoder(model_config, preprocess_config, args.vocoder_ckpt,
                          device)
    synthesizer = Synthesizer(model, cfg, preprocess_config, device,
                              vocoder=vocoder)
    source = os.path.join(pre_path, f"{args.split}.txt")
    names, speakers, texts, raw_texts = FeatureDataset._read_metadata(source)
    speaker_ids = load_metadata_rows(preprocess_config, source)[1]
    sr = pp["audio"]["sampling_rate"]
    hop = pp["stft"]["hop_length"]
    max_wav_value = pp["audio"]["max_wav_value"]
    cleaners = pp["text"]["text_cleaners"]
    rows = []
    for name, spk, spk_id, phones, raw in zip(names, speakers, speaker_ids,
                                              texts, raw_texts):
        if len(rows) >= args.objective:
            break
        wav_path = os.path.join(wav_dir, f"{spk}-wav-{name}.npy")
        if not os.path.exists(wav_path):
            continue
        gt = np.load(wav_path).astype(np.float32)
        ids = np.asarray(text_to_sequence(phones, cleaners), np.int64)
        out = synthesizer.infer_ids([ids], np.asarray([spk_id], np.int64))
        syn = vocoder_infer(out.postnet_mel, vocoder, preprocess_config,
                            lengths=out.mel_len.cpu().numpy())[0]
        syn = syn.astype(np.float32) / max_wav_value
        row = {"name": name,
               "mcd_db": round(mcd(gt, syn, sr, hop_length=hop,
                                   device=device), 3),
               "duration_ratio": round(len(syn) / max(len(gt), 1), 4)}
        n = min(len(gt), len(syn))
        row.update({k: round(v, 4) for k, v in f0_metrics(
            gt[:n], syn[:n], sr, hop, device=device).items()})
        if args.save_dir:
            from fastspeech2_tpu_torch.audio.wav import save_wav

            os.makedirs(args.save_dir, exist_ok=True)
            save_wav(os.path.join(args.save_dir, f"{name}_tts.wav"), syn,
                     sr)
            row["raw_text"] = raw
        rows.append(row)
    if not rows:
        print("--objective: no val utterances with saved GT wavs found")
        return None
    for r in rows:
        print(json.dumps(r))
    summary = {"objective_mean": {
        "mcd_db": round(float(np.mean([r["mcd_db"] for r in rows])), 3),
        "duration_ratio": round(float(np.mean([r["duration_ratio"]
                                               for r in rows])), 4),
        "n": len(rows)}}
    print(json.dumps(summary))
    if args.save_dir:
        with open(os.path.join(args.save_dir, "metrics.json"), "w") as f:
            json.dump({"rows": rows, **summary}, f, indent=1)
    return rows


def write_synth_sample(args, preprocess_config, model_config, train_config,
                       model, cfg, val_dataset, device):
    """The first validation utterance through synth_one_sample
    (fastspeech2_tpu/cli/evaluate_cli.py:79-104) -> the written paths."""
    from scipy.io import wavfile

    from fastspeech2_tpu_torch.data.dataset import collate_batch
    from fastspeech2_tpu_torch.synthesis.vocoder import get_vocoder
    from fastspeech2_tpu_torch.training.loop import synth_one_sample

    vocoder = get_vocoder(model_config, preprocess_config, args.vocoder_ckpt,
                          device)
    batch = collate_batch([val_dataset[0]], max_mel_len=cfg.max_seq_len)
    fig, wav_rec, wav_pred = synth_one_sample(model, batch,
                                              preprocess_config, vocoder)
    result_path = train_config["path"]["result_path"]
    os.makedirs(result_path, exist_ok=True)
    base = os.path.join(result_path, f"val_step_{args.restore_step or 0}")
    written = []
    if fig is not None:
        from matplotlib import pyplot as plt

        fig.savefig(base + ".png")
        plt.close(fig)
        written.append(base + ".png")
    sr = preprocess_config["preprocessing"]["audio"]["sampling_rate"]
    for name, wav in (("reconstructed", wav_rec), ("synthesized", wav_pred)):
        wavfile.write(f"{base}_{name}.wav", sr, wav)
        written.append(f"{base}_{name}.wav")
    print(f"Synth sample written to {', '.join(written)}")
    return written


if __name__ == "__main__":
    main()
