"""Score a ladder of vocoder checkpoints in one process (port of
``scripts/score_vocoder_ladder.py``).

Copy synthesis of the same clips (``evaluation/vocoder_eval.py``) through
each checkpoint in turn: the vocoder is built once, from the first
checkpoint, and each later one is loaded into it in place (its generator
config must be the first one's: a ladder is one architecture's
checkpoints over training).  A checkpoint is a tracked npz snapshot, a
torch ``{"generator": ...}`` file, or the port's vocoder checkpoint (its
train state or lean export); the generator-config keys that two
checkpoints both name must agree, and the weights load strictly.  One
JSON line per checkpoint.  Runs on the
card unless ``--device cpu`` is given.

    python -m fastspeech2_tpu_torch.tools.score_vocoder_ladder \\
        --vocoder HiFi-GAN-iSTFT \\
        --ckpts weights/vocoder_gen_mixed60k.npz output/vocoder/20.pth.tar \\
        --wav_glob 'raw_data/LJSpeech10/LJSpeech/*.wav'
"""

import argparse
import glob
import json
import os


def score_ladder(vocoder_name, ckpts, wavs, sr=22050, save_dir=None,
                 device="cuda", log=print):
    """-> one {"ckpt", "mean", "n_files"} dict per checkpoint, in order."""
    from fastspeech2_tpu_torch.evaluation.vocoder_eval import (
        evaluate_vocoder,
    )
    from fastspeech2_tpu_torch.synthesis.vocoder import (
        GENERATOR_KEYS,
        MelGANVocoder,
        _tuples,
        generator_weights,
        get_vocoder,
    )

    def topology(config):
        return {k: _tuples(config[k]) for k in GENERATOR_KEYS if k in config}

    model_config = {"vocoder": {"model": vocoder_name,
                                "speaker": "LJSpeech"}}
    pre_config = {"preprocessing": {
        "audio": {"sampling_rate": sr, "max_wav_value": 32768.0},
        "stft": {"filter_length": 1024, "hop_length": 256,
                 "win_length": 1024},
        "mel": {"n_mel_channels": 80, "mel_fmin": 0, "mel_fmax": 8000}}}
    vocoder = get_vocoder(model_config, pre_config, ckpts[0], device)
    generator = (vocoder.generator if isinstance(vocoder, MelGANVocoder)
                 else vocoder)
    first_config = None
    rows = []
    for ckpt in ckpts:
        config, state = generator_weights(vocoder_name, ckpt)
        config = topology(config)
        if first_config is None:
            first_config = config
        elif any(config[k] != first_config[k]
                 for k in config.keys() & first_config.keys()):
            raise ValueError(f"{ckpt}: generator config {config} is not "
                             f"the ladder's {first_config}")
        generator.load_state_dict(state)
        tag = os.path.basename(ckpt.rstrip("/")) or ckpt
        per_file, mean = evaluate_vocoder(
            vocoder, wavs, sr,
            save_dir=os.path.join(save_dir, tag) if save_dir else None,
            device=device)
        row = {"ckpt": ckpt, "mean": mean, "n_files": len(per_file)}
        log(json.dumps(row))
        rows.append(row)
    return rows


def main(argv=None):
    from fastspeech2_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vocoder", default="HiFi-GAN-iSTFT")
    ap.add_argument("--ckpts", nargs="+", required=True,
                    help="npz snapshots and/or .pth.tar checkpoints, "
                         "scored in order")
    ap.add_argument("--wav_glob",
                    default="raw_data/LJSpeech10/LJSpeech/*.wav")
    ap.add_argument("--sr", type=int, default=22050)
    ap.add_argument("--save_dir", default=None,
                    help="write <ckpt-tag>/<name>_copysyn.wav under here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    wavs = sorted(glob.glob(args.wav_glob))
    if not wavs:
        raise SystemExit(f"no wavs match {args.wav_glob}")
    return score_ladder(args.vocoder, args.ckpts, wavs, args.sr,
                        args.save_dir, resolve_device(args.device))


if __name__ == "__main__":
    main()
