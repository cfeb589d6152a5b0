"""Copy-synthesis vocoder evaluation (port of
``fastspeech2_tpu/evaluation/vocoder_eval.py``): GT wav -> mel -> vocoder
-> wav, scored against the original with the objective metrics (MCD, F0
RMSE, voicing F1).

This isolates VOCODER quality from acoustic-model quality.  Works with any
checkpoint ``synthesis/vocoder.py::get_vocoder`` accepts: a tracked npz
snapshot, a torch ``{"generator": ...}`` .pth.tar, or the port's vocoder
checkpoint (its train state or lean export).  Runs on the card unless
``--device cpu`` is given.

    python -m fastspeech2_tpu_torch.evaluation.vocoder_eval \\
        --vocoder HiFi-GAN-iSTFT --ckpt weights/vocoder_gen_mixed60k.npz \\
        /path/to/gt1.wav /path/to/gt2.wav [--device cuda|cpu]
"""

import argparse
import json
import os

import numpy as np
import torch


def evaluate_vocoder(vocoder, wav_paths, sampling_rate=22050,
                     hop_length=256, max_wav_value=32768.0,
                     save_dir=None, device="cuda"):
    """-> (per-file metric dicts, mean-metrics dict).

    save_dir, if given, receives <name>_copysyn.wav next to the metrics
    so results can be listened to (and fed to demo_page.py)."""
    from fastspeech2_tpu_torch.audio.stft import MelSpectrogram
    from fastspeech2_tpu_torch.audio.wav import load_wav, save_wav
    from fastspeech2_tpu_torch.evaluation.metrics import f0_metrics, mcd
    from fastspeech2_tpu_torch.synthesis.vocoder import vocoder_infer

    mel_fn = MelSpectrogram(sampling_rate=sampling_rate,
                            hop_length=hop_length)
    pre = {"preprocessing": {
        "audio": {"max_wav_value": max_wav_value},
        "stft": {"hop_length": hop_length}}}
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    per_file = []
    for path in wav_paths:
        gt, _ = load_wav(path, sampling_rate)
        gt = gt.astype(np.float32)
        with torch.inference_mode():
            mel, _ = mel_fn(torch.as_tensor(gt, device=device)[None, :])
        mel = mel.transpose(1, 2)                       # [1, frames, 80]
        n_frames = mel.shape[1]
        syn = vocoder_infer(mel, vocoder, pre,
                            lengths=[n_frames])[0] / max_wav_value
        if save_dir:
            base = os.path.splitext(os.path.basename(path))[0]
            save_wav(os.path.join(save_dir, f"{base}_copysyn.wav"),
                     syn, sampling_rate)
        n = min(len(gt), len(syn))
        row = {"file": path,
               "mcd_db": round(mcd(gt[:n], syn[:n], sampling_rate,
                                   hop_length=hop_length, device=device), 3)}
        row.update({k: round(v, 4) for k, v in
                    f0_metrics(gt[:n], syn[:n], sampling_rate, hop_length,
                               device=device).items()})
        per_file.append(row)
    keys = [k for k in per_file[0] if k != "file"]
    mean = {k: round(float(np.mean([r[k] for r in per_file])), 4)
            for k in keys}
    return per_file, mean


def main(argv=None):
    from fastspeech2_tpu_torch.synthesis.vocoder import get_vocoder
    from fastspeech2_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("wavs", nargs="+")
    ap.add_argument("--vocoder", default="HiFi-GAN-iSTFT",
                    help="vocoder.model name (HiFi-GAN, HiFi-GAN-iSTFT, "
                         "HiFi-GAN-iSTFT-C8C2I, MelGAN)")
    ap.add_argument("--ckpt", default=None,
                    help="npz snapshot, torch .pth.tar or the port's "
                         "vocoder checkpoint (default: bundled speaker ckpt "
                         "if present, else random init)")
    ap.add_argument("--speaker", default="LJSpeech")
    ap.add_argument("--sr", type=int, default=22050)
    ap.add_argument("--save_dir", default=None,
                    help="also write <name>_copysyn.wav files here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    model_config = {"vocoder": {"model": args.vocoder,
                                "speaker": args.speaker}}
    pre_config = {"preprocessing": {
        "audio": {"sampling_rate": args.sr, "max_wav_value": 32768.0},
        "stft": {"filter_length": 1024, "hop_length": 256,
                 "win_length": 1024},
        "mel": {"n_mel_channels": 80, "mel_fmin": 0, "mel_fmax": 8000}}}
    vocoder = get_vocoder(model_config, pre_config, args.ckpt, device)
    per_file, mean = evaluate_vocoder(vocoder, args.wavs, args.sr,
                                      save_dir=args.save_dir, device=device)
    for row in per_file:
        print(json.dumps(row))
    print(json.dumps({"mean": mean, "n_files": len(per_file)}))
    return per_file, mean


if __name__ == "__main__":
    main()
