"""Prosody-control sweep (port of
``fastspeech2_tpu/evaluation/prosody_sweep.py``): verify p/e/d controls
objectively and produce demo artifacts.

The reference advertises pitch/energy/duration control ratios
(reference synthesize.py:91-96, model/modules.py:124,146 — where the
energy control is half-broken upstream; fixed in models/variance.py).
This tool measures what the three controls actually do on trained
weights, in both control modes (synthesis/pipeline.py
Synthesizer(control_mode=...)):

- duration_control d: synthesized frame count scales ~d (both modes);
- pitch_control p / energy_control e: the PREDICTION-level effect is
  gated exactly per mode ("reference": z scales by r; "absolute": the
  denormalized Hz/energy value scales by r).  The WAV-level effect is
  measured pairwise against the r=1.0 wav — per-frame F0 ratio over
  frames DIO voices in both (durations match, so frames align), and
  per-frame RMS ratio over active frames — medians are robust where
  global voiced-means are not on imperfect vocoder audio.

    python -m fastspeech2_tpu_torch.evaluation.prosody_sweep \
        -p config/LJSpeech10/preprocess.yaml -m config/LJSpeech10/model.yaml \
        -t config/LJSpeech10/train.yaml \
        --weights_npz weights/acoustic_LJSpeech10_100k.npz \
        --vocoder_ckpt weights/vocoder_gen_mixed60k.npz \
        --text "..." --save_dir demo/prosody [--device cuda|cpu]

The acoustic model and the vocoder run on the card unless ``--device
cpu`` is given; so does DIO.

Writes <save_dir>/<mode>/{pitch,energy,duration}_<ratio>.wav,
<save_dir>/sweep.json with measured ratios and pass/fail gates, and
<save_dir>/index.html (listening page).
"""

import argparse
import html as _html
import json
import os

import numpy as np
import torch

RATIOS = (0.8, 1.0, 1.2)
_F0_PAD = 65536  # samples; the JAX package's static DIO length per sweep


def wav_f0(wav, sr, hop_length, pad_to=_F0_PAD, device="cuda"):
    """DIO F0 track of a float wav, computed at a padded length (the JAX
    package's static shape, so the tracks are the same); trimmed to real
    frames."""
    from fastspeech2_tpu_torch.audio.dio import dio_f0

    n = len(wav)
    padded = int(np.ceil(max(n, 1) / pad_to) * pad_to)
    buf = np.zeros(padded, np.float32)
    buf[:n] = wav
    with torch.inference_mode():
        f0 = dio_f0(torch.as_tensor(buf, device=device), sr,
                    hop_length).cpu().numpy()
    return f0[: n // hop_length]


def frame_rms(wav, hop_length):
    n = len(wav) // hop_length
    frames = np.asarray(wav[: n * hop_length], np.float32).reshape(
        n, hop_length)
    return np.sqrt((frames ** 2).mean(axis=1))


def paired_f0_ratio(f0_base, f0_test):
    """Median per-frame F0 ratio over frames voiced in BOTH tracks.
    -> (ratio or None, n_frames)."""
    n = min(len(f0_base), len(f0_test))
    both = (f0_base[:n] > 0) & (f0_test[:n] > 0)
    if both.sum() == 0:
        return None, 0
    r = f0_test[:n][both] / f0_base[:n][both]
    return float(np.median(r)), int(both.sum())


def paired_rms_ratio(rms_base, rms_test):
    """Median per-frame RMS ratio over frames active in both."""
    n = min(len(rms_base), len(rms_test))
    floor = 0.2 * np.median(rms_base[rms_base > 1e-4])
    m = (rms_base[:n] > floor) & (rms_test[:n] > floor)
    if m.sum() == 0:
        return None, 0
    return float(np.median(rms_test[:n][m] / rms_base[:n][m])), int(
        m.sum())


def _pred_means(pred, n_valid, mean, std):
    """(z-space masked mean, denormalized masked mean) of prediction
    row 0."""
    v = pred[0, :n_valid].float().cpu().numpy()
    return float(v.mean()), float((v * std + mean).mean())


def sweep(synthesizer, vocoder, preprocess_config, text, save_dir=None,
          speaker=0, ratios=RATIOS):
    """-> {control: {ratio: {...measurements}}} (+ wavs in save_dir)."""
    from fastspeech2_tpu_torch.synthesis.vocoder import vocoder_infer

    pp = preprocess_config["preprocessing"]
    sr = pp["audio"]["sampling_rate"]
    hop = pp["stft"]["hop_length"]
    max_wav = pp["audio"]["max_wav_value"]
    stats_path = os.path.join(
        preprocess_config["path"]["preprocessed_path"], "stats.json")
    with open(stats_path) as f:
        stats = json.load(f)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)

    ids, _phones = synthesizer.text_to_ids(text)

    def synth_point(control, r):
        kw = {f"{control[0]}_control": r} if r is not None else {}
        out = synthesizer.infer_ids([np.asarray(ids, np.int64)],
                                    np.asarray([speaker], np.int64), **kw)
        n = int(out.mel_len[0])
        wav = vocoder_infer(out.postnet_mel[:1].float(), vocoder,
                            preprocess_config, lengths=[n])[0]
        return out, wav.astype(np.float32) / max_wav

    results = {}
    for control in ("pitch", "energy", "duration"):
        results[control] = {}
        base_f0 = base_rms = None
        # r=1.0 first: it is the pairwise baseline for the other points
        order = sorted(ratios, key=lambda r: abs(r - 1.0))
        for r in order:
            out, wav = synth_point(control, r)
            n = int(out.mel_len[0])
            n_src = int(out.src_len[0])
            p_z, p_hz = _pred_means(out.pitch_prediction, n_src,
                                    *stats["pitch"][2:4])
            e_z, e_abs = _pred_means(out.energy_prediction, n_src,
                                     *stats["energy"][2:4])
            row = {
                "mel_frames": n,
                "pred_f0_z": round(p_z, 4),
                "pred_f0_hz": round(p_hz, 2),
                "pred_energy_z": round(e_z, 4),
                "pred_energy": round(e_abs, 3),
            }
            # pairwise wav-level measurements vs the r=1.0 point
            # (durations match within a pitch/energy sweep, so frames
            # align)
            if control in ("pitch", "energy"):
                f0 = wav_f0(wav, sr, hop, device=synthesizer.device)
                rms = frame_rms(wav, hop)
                if base_f0 is None:  # first point is r=1.0 (see order)
                    base_f0, base_rms = f0, rms
                fr, nf = paired_f0_ratio(base_f0, f0)
                rr, nr = paired_rms_ratio(base_rms, rms)
                row["wav_f0_ratio"] = (None if fr is None
                                       else round(fr, 3))
                row["wav_f0_frames"] = nf
                row["wav_rms_ratio"] = (None if rr is None
                                        else round(rr, 3))
                row["wav_rms_frames"] = nr
            if save_dir:
                from fastspeech2_tpu_torch.audio.wav import save_wav

                path = os.path.join(save_dir, f"{control}_{r:.1f}.wav")
                save_wav(path, wav, sr)
                row["wav"] = os.path.basename(path)
            results[control][f"{r:.1f}"] = row
    return results


def verify(results, ratios=RATIOS, mode="reference"):
    """-> (ok, checks), gating what each mode actually promises.

    Both modes: duration frames scale ~d.  "reference" mode promises
    the z-scored PREDICTION scales by r (model/modules.py:124,146) —
    gated via z-space means (Hz direction is NOT guaranteed: v' - v =
    (r-1)*z*std flips sign with z).  "absolute" mode promises the
    DENORMALIZED value scales by r — gated to 5% on predicted Hz /
    energy, plus weak monotonicity of the pairwise wav-level medians
    (low-ratio median < high-ratio median); the magnitudes are
    reported, not gated — how fully the decoder REALIZES an
    off-distribution variance embedding is a property of the acoustic
    training corpus, not of the control path.
    """
    lo, mid, hi = (f"{r:.1f}" for r in ratios)
    checks = {}
    d = results["duration"]
    ratio_lo = d[lo]["mel_frames"] / d[mid]["mel_frames"]
    ratio_hi = d[hi]["mel_frames"] / d[mid]["mel_frames"]
    checks["duration"] = {
        "frames_ratio_low": round(ratio_lo, 3),
        "frames_ratio_high": round(ratio_hi, 3),
        "ok": abs(ratio_lo - ratios[0]) < 0.1 and abs(
            ratio_hi - ratios[2]) < 0.1,
    }
    p = results["pitch"]
    pred_lo = p[lo]["pred_f0_hz"] / p[mid]["pred_f0_hz"]
    pred_hi = p[hi]["pred_f0_hz"] / p[mid]["pred_f0_hz"]
    wav_lo, wav_hi = p[lo].get("wav_f0_ratio"), p[hi].get("wav_f0_ratio")
    pitch = {
        "pred_f0_ratio_low": round(pred_lo, 3),
        "pred_f0_ratio_high": round(pred_hi, 3),
        "wav_f0_ratio_low": wav_lo,
        "wav_f0_ratio_high": wav_hi,
    }
    if mode == "absolute":
        pitch["ok"] = (abs(pred_lo - ratios[0]) < 0.05
                       and abs(pred_hi - ratios[2]) < 0.05
                       and wav_lo is not None and wav_hi is not None
                       and wav_lo < wav_hi)
    else:
        pitch["ok"] = (
            abs(p[lo]["pred_f0_z"] - ratios[0] * p[mid]["pred_f0_z"])
            < 2e-3
            and abs(p[hi]["pred_f0_z"] - ratios[2] * p[mid]["pred_f0_z"])
            < 2e-3)
    checks["pitch"] = pitch
    e = results["energy"]
    en_lo = e[lo]["pred_energy"] / e[mid]["pred_energy"]
    en_hi = e[hi]["pred_energy"] / e[mid]["pred_energy"]
    rms_lo, rms_hi = e[lo].get("wav_rms_ratio"), e[hi].get("wav_rms_ratio")
    energy = {
        "pred_energy_ratio_low": round(en_lo, 3),
        "pred_energy_ratio_high": round(en_hi, 3),
        "wav_rms_ratio_low": rms_lo,
        "wav_rms_ratio_high": rms_hi,
    }
    if mode == "absolute":
        energy["ok"] = (abs(en_lo - ratios[0]) < 0.05
                        and abs(en_hi - ratios[2]) < 0.05
                        and rms_lo is not None and rms_hi is not None
                        and rms_lo <= rms_hi)
    else:
        energy["ok"] = (
            abs(e[lo]["pred_energy_z"]
                - ratios[0] * e[mid]["pred_energy_z"]) < 2e-3
            and abs(e[hi]["pred_energy_z"]
                    - ratios[2] * e[mid]["pred_energy_z"]) < 2e-3)
    checks["energy"] = energy
    return all(c["ok"] for c in checks.values()), checks


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Prosody control sweep</title>
<style>
body {{ font-family: sans-serif; max-width: 60rem; margin: 2rem auto; }}
table {{ border-collapse: collapse; width: 100%; margin-bottom: 2rem; }}
td, th {{ padding: .5rem .7rem; border-bottom: 1px solid #ddd;
          text-align: left; }}
audio {{ width: 13rem; }}
.meas {{ color: #666; font-size: .85rem; }}
</style></head><body>
<h1>Prosody control sweep</h1>
<p>{subtitle}</p>
{tables}
</body></html>
"""


def write_sweep_page(out, save_dir):
    """Build <save_dir>/index.html from a sweep() result dict."""
    tables = []
    for mode, m in out["modes"].items():
        rows = []
        for control, pts in m["results"].items():
            cells = []
            for r, row in pts.items():
                wav = row.get("wav")
                src = f"{mode}/{wav}" if wav else ""
                meas = []
                if control == "duration":
                    meas.append(f"{row['mel_frames']} frames")
                elif control == "pitch":
                    meas.append(f"pred {row['pred_f0_hz']} Hz")
                    if row.get("wav_f0_ratio") is not None:
                        meas.append(f"wav ×{row['wav_f0_ratio']}")
                else:
                    meas.append(f"pred {row['pred_energy']}")
                    if row.get("wav_rms_ratio") is not None:
                        meas.append(f"rms ×{row['wav_rms_ratio']}")
                cells.append(
                    f"<td><audio controls src=\"{_html.escape(src)}\">"
                    f"</audio><div class=\"meas\">"
                    f"{_html.escape(', '.join(meas))}</div></td>")
            ok = m["checks"][control]["ok"]
            rows.append(f"<tr><td><b>{control}</b><br>"
                        f"{'pass' if ok else 'FAIL'}</td>"
                        + "".join(cells) + "</tr>")
        header = "".join(f"<th>&times;{r:.1f}</th>" for r in RATIOS)
        tables.append(
            f"<h2>control_mode = {_html.escape(mode)}</h2>"
            f"<table><tr><th>control</th>{header}</tr>"
            + "\n".join(rows) + "</table>")
    path = os.path.join(save_dir, "index.html")
    with open(path, "w") as f:
        f.write(_PAGE.format(subtitle=_html.escape(out["text"]),
                             tables="\n".join(tables)))
    return path


def main(argv=None):
    from fastspeech2_tpu_torch.cli.synthesize_cli import (
        add_weights_args,
        load_model_for_inference,
    )
    from fastspeech2_tpu_torch.configs.config import load_yaml_configs
    from fastspeech2_tpu_torch.synthesis.pipeline import Synthesizer
    from fastspeech2_tpu_torch.synthesis.vocoder import get_vocoder
    from fastspeech2_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-p", "--preprocess_config", required=True)
    ap.add_argument("-m", "--model_config", required=True)
    ap.add_argument("-t", "--train_config", required=True)
    add_weights_args(ap)
    ap.add_argument("--vocoder_ckpt", default=None)
    ap.add_argument("--text", default="The quick brown fox jumps over "
                                      "the lazy dog.")
    ap.add_argument("--speaker", type=int, default=0)
    ap.add_argument("--save_dir", default=None)
    ap.add_argument("--control_mode", default="both",
                    choices=("reference", "absolute", "both"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    preprocess_config, model_config, train_config = load_yaml_configs(
        args.preprocess_config, args.model_config, args.train_config)
    model, cfg = load_model_for_inference(
        preprocess_config, model_config, args.weights_npz, device,
        train_config=train_config, restore_step=args.restore_step,
        torch_ckpt=args.torch_ckpt)
    vocoder = get_vocoder(model_config, preprocess_config,
                          args.vocoder_ckpt, device)
    modes = (("reference", "absolute") if args.control_mode == "both"
             else (args.control_mode,))
    out = {"text": args.text, "modes": {}}
    all_ok = True
    for mode in modes:
        synthesizer = Synthesizer(model, cfg, preprocess_config, device,
                                  vocoder=vocoder, control_mode=mode)
        save_dir = (os.path.join(args.save_dir, mode)
                    if args.save_dir else None)
        results = sweep(synthesizer, vocoder, preprocess_config, args.text,
                        save_dir=save_dir, speaker=args.speaker)
        ok, checks = verify(results, mode=mode)
        all_ok = all_ok and ok
        out["modes"][mode] = {"results": results, "checks": checks,
                              "ok": ok}
    out["all_ok"] = all_ok
    print(json.dumps(out, indent=1))
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
        with open(os.path.join(args.save_dir, "sweep.json"), "w") as f:
            json.dump(out, f, indent=1)
        page = write_sweep_page(out, args.save_dir)
        print(f"Wrote {page}")
    return out


if __name__ == "__main__":
    main()
