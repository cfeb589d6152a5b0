"""Leave-one-out held-out evaluation on the 10-clip corpus, through the
port's CLIs (port of ``scripts/leave_one_out.py``).

A voice is worth its generalization to unseen text.  For each fold this
tool trains the full system (acoustic model + vocoder, both stages) on 9
of the 10 clips, synthesizes the held-out transcript from raw phones,
and scores it against the held-out ground-truth audio (DTW-MCD, F0 RMSE,
voicing F1, duration ratio).

Per fold:
  1. build a fold corpus (symlinked features, train.txt = 9 clips,
     val.txt = the held-out clip) + fold configs;
  2. cli.train_cli       — acoustic model on the 9 clips;
  3. cli.export_mels_cli — teacher-forced predicted mels (train split);
  4. cli.train_vocoder_cli — stage A from scratch on GT mels
     (--split train.txt keeps the held-out clip out of GAN training),
     then stage B GT-aligned fine-tune on predicted mels;
  5. cli.evaluate_cli --objective — score the held-out clip (--split val)
     and the 9 training clips (--split train) for the train/held-out gap;
     evaluation.vocoder_eval copy-synthesizes the held-out clip and one
     training clip through the fold's vocoder.

The copy-synthesis rows are matched to their clips by their "file" field
(the JAX script took them by position, ``scripts/leave_one_out.py:226``),
fewer than two rows fail with the log's path, and a summary.json that
does not parse is replaced by a fresh one.

Known residual contamination, documented rather than hidden: stats.json
(pitch/energy normalization scalars) and the duration alignments were
computed over all 10 clips.  Both are scalar/frame-count side channels,
not audio or transcript content, and the held-out clip's features are
never read during training.

Usage (from the repo root; on the card unless --device cpu):
  python -m fastspeech2_tpu_torch.tools.leave_one_out \
      --folds LJ001-0012 LJ021-0108 LJ042-0094 \
      --acoustic_steps 40000 --voc_stage_a 20000 --voc_stage_b 10000
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BASE_PRE = REPO / "preprocessed_data" / "LJSpeech10"
BASE_CFG = REPO / "config" / "LJSpeech10"


def run(cmd, log_path):
    print(f"[loo] $ {' '.join(map(str, cmd))}", flush=True)
    t0 = time.time()
    with open(log_path, "ab") as f:
        f.write(("\n$ " + " ".join(map(str, cmd)) + "\n").encode())
        f.flush()
        subprocess.run(list(map(str, cmd)), check=True, stdout=f,
                       stderr=subprocess.STDOUT, cwd=REPO)
    print(f"[loo]   done in {time.time() - t0:.0f}s", flush=True)


def build_fold(fold, out_root):
    """Fold corpus: feature dirs symlinked, metadata split around `fold`."""
    fold_pre = out_root / "preprocessed"
    fold_pre.mkdir(parents=True, exist_ok=True)
    for d in ("mel", "pitch", "energy", "duration", "wav"):
        link = fold_pre / d
        if not link.exists():
            link.symlink_to(BASE_PRE / d)
    for f in ("stats.json", "speakers.json"):
        link = fold_pre / f
        if not link.exists():
            link.symlink_to(BASE_PRE / f)
    lines = (BASE_PRE / "train.txt").read_text().splitlines(keepends=True)
    held = [ln for ln in lines if ln.split("|")[0] == fold]
    rest = [ln for ln in lines if ln.split("|")[0] != fold]
    if len(held) != 1:
        raise SystemExit(f"fold {fold}: expected exactly one metadata line, "
                         f"found {len(held)}")
    (fold_pre / "train.txt").write_text("".join(rest))
    (fold_pre / "val.txt").write_text("".join(held))
    return fold_pre


def write_configs(fold, fold_pre, out_root, acoustic_steps):
    import yaml

    cfg_dir = out_root / "config"
    cfg_dir.mkdir(exist_ok=True)
    pre = yaml.safe_load((BASE_CFG / "preprocess.yaml").read_text())
    pre["path"]["preprocessed_path"] = str(fold_pre)
    (cfg_dir / "preprocess.yaml").write_text(yaml.safe_dump(pre))

    (cfg_dir / "model.yaml").write_text(
        (BASE_CFG / "model.yaml").read_text())

    tr = yaml.safe_load((BASE_CFG / "train.yaml").read_text())
    tr["path"]["ckpt_path"] = str(out_root / "ckpt")
    tr["path"]["log_path"] = str(out_root / "log")
    tr["path"]["result_path"] = str(out_root / "result")
    tr["optimizer"]["batch_size"] = 9
    tr["step"]["total_step"] = acoustic_steps
    tr["step"]["save_step"] = acoustic_steps
    (cfg_dir / "train.yaml").write_text(yaml.safe_dump(tr))
    return cfg_dir


def read_metrics(save_dir):
    with open(Path(save_dir) / "metrics.json") as f:
        return json.load(f)


def copysyn_rows(log_path, heldout_wav, anchor_wav):
    """The vocoder_eval rows of the held-out clip and the training anchor,
    matched by their "file" field -> {"heldout": row, "train_anchor":
    row}."""
    rows = {}
    for line in Path(log_path).read_text().splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            if "file" in row:
                rows[os.path.abspath(row["file"])] = row
    if len(rows) < 2:
        raise SystemExit(f"{log_path}: expected copy-synthesis rows for 2 "
                         f"clips, found {len(rows)}")
    out = {}
    for key, wav in (("heldout", heldout_wav), ("train_anchor", anchor_wav)):
        row = rows.get(os.path.abspath(wav))
        if row is None:
            raise SystemExit(f"{log_path}: no copy-synthesis row for {wav}")
        out[key] = row
    return out


def read_summary(path):
    """The accumulated summary, or a fresh one when the file is missing
    or does not parse (a run cut off while writing it)."""
    try:
        summary = json.loads(Path(path).read_text())
    except (FileNotFoundError, json.JSONDecodeError):
        summary = {}
    if not isinstance(summary, dict):
        summary = {}
    summary.setdefault("folds", {})
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--folds", nargs="+", required=True,
                    help="utterance basenames to hold out, one fold each")
    ap.add_argument("--out_root", default="output/loo")
    ap.add_argument("--acoustic_steps", type=int, default=40000)
    ap.add_argument("--voc_stage_a", type=int, default=20000)
    ap.add_argument("--voc_stage_b", type=int, default=10000)
    ap.add_argument("--voc_batch", type=int, default=16)
    ap.add_argument("--voc_scan", type=int, default=500)
    ap.add_argument("--mel_weight", type=float, default=135.0)
    ap.add_argument("--skip_train_eval", action="store_true")
    ap.add_argument("--voc_aug_gain_db", type=float, default=0.0,
                    help="vocoder augmentation: random per-segment gain "
                         "U[-d,+d] dB in both stages (an out-of-"
                         "distribution robustness experiment)")
    ap.add_argument("--voc_aug_speed", default=None, metavar="LO,HI",
                    help="vocoder augmentation: playback-rate "
                         "perturbation in stage A (switches stage A to "
                         "mel_source gt_wav so the input mel follows "
                         "the resampled waveform)")
    ap.add_argument("--voc_tag", default="vocoder",
                    help="vocoder output subdir: give each augmentation "
                         "arm its own tag to train multiple vocoders "
                         "against one fold acoustic model")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, for every CLI run")
    args = ap.parse_args(argv)
    dev = ["--device", args.device]

    py = sys.executable
    out_base = REPO / args.out_root
    out_base.mkdir(parents=True, exist_ok=True)
    summary_path = out_base / "summary.json"
    # accumulate across invocations (each fold:tag is one entry)
    summary = read_summary(summary_path)
    summary["args"] = vars(args)

    for fold in args.folds:
        out_root = out_base / fold
        out_root.mkdir(parents=True, exist_ok=True)
        log_path = out_root / "loo.log"
        fold_pre = build_fold(fold, out_root)
        cfg_dir = write_configs(fold, fold_pre, out_root,
                                args.acoustic_steps)
        cfg = ["-p", cfg_dir / "preprocess.yaml",
               "-m", cfg_dir / "model.yaml",
               "-t", cfg_dir / "train.yaml"]

        # 1. acoustic model on 9 clips
        if not (out_root / "ckpt"
                / f"{args.acoustic_steps}.pth.tar").exists():
            run([py, "-m", "fastspeech2_tpu_torch.cli.train_cli", *cfg,
                 "--dtype", "bfloat16", *dev], log_path)

        # 2. teacher-forced predicted mels (train split only; already
        # present when a second vocoder arm reuses the fold acoustic)
        if not (fold_pre / "mel_pred").exists():
            run([py, "-m", "fastspeech2_tpu_torch.cli.export_mels_cli", *cfg,
                 "--restore_step", args.acoustic_steps,
                 "--teacher_force", "d", *dev], log_path)

        # 3. vocoder stage A (GT mels, from scratch) + stage B (predicted)
        voc_dir = out_root / args.voc_tag
        common = [py, "-m", "fastspeech2_tpu_torch.cli.train_vocoder_cli",
                  "--finetune_from", fold_pre,
                  "--split", "train.txt",
                  "--out_dir", voc_dir,
                  "--config",
                  "fastspeech2_tpu_torch/configs/hifigan/config_istft.json",
                  "--batch_size", args.voc_batch,
                  "--scan_step", args.voc_scan,
                  "--mel_weight", args.mel_weight,
                  "--save_step", 5000, "--log_step", 500, *dev]
        aug = []
        if args.voc_aug_gain_db:
            aug += ["--aug_gain_db", args.voc_aug_gain_db]
        stage_a_src = "gt"
        stage_a_aug = list(aug)
        if args.voc_aug_speed:
            # speed perturbation needs in-graph mels (stage A only; the
            # predicted-mel stage keeps gain, which is exact on
            # external log-mels)
            stage_a_src = "gt_wav"
            stage_a_aug += ["--aug_speed", args.voc_aug_speed]
        run([*common, "--mel_source", stage_a_src, *stage_a_aug,
             "--total_steps", args.voc_stage_a], log_path)
        total = args.voc_stage_a + args.voc_stage_b
        run([*common, "--mel_source", "pred", *aug,
             "--total_steps", total], log_path)

        # 4. held-out + training-set objective scores
        voc_ckpt = voc_dir / f"{total}.pth.tar"
        eval_common = [py, "-m", "fastspeech2_tpu_torch.cli.evaluate_cli",
                       *cfg, "--restore_step", args.acoustic_steps,
                       "--vocoder_ckpt", voc_ckpt, *dev]
        held_dir = out_root / f"eval_heldout_{args.voc_tag}"
        run([*eval_common, "--objective", "1", "--split", "val",
             "--save_dir", held_dir], log_path)
        fold_result = {"heldout": read_metrics(held_dir)}

        # 4b. vocoder OOD diagnostic: copy-synthesize the held-out clip's
        # GT mel through the fold vocoder (and one training clip as the
        # in-distribution anchor) — isolates the vocoder's share of the
        # held-out gap (docs/heldout_eval.md "blame decomposes")
        raw_dir = REPO / "raw_data" / "LJSpeech10" / "LJSpeech"
        train_first = (fold_pre / "train.txt").read_text().split("|")[0]
        copysyn_log = out_root / f"copysyn_{args.voc_tag}.json"
        heldout_wav = raw_dir / f"{fold}.wav"
        anchor_wav = raw_dir / f"{train_first}.wav"
        run([py, "-m", "fastspeech2_tpu_torch.evaluation.vocoder_eval",
             "--vocoder", "HiFi-GAN-iSTFT", "--ckpt", voc_ckpt,
             heldout_wav, anchor_wav, *dev], copysyn_log)
        fold_result["copysyn"] = copysyn_rows(copysyn_log, heldout_wav,
                                              anchor_wav)
        if not args.skip_train_eval:
            train_dir = out_root / f"eval_train_{args.voc_tag}"
            run([*eval_common, "--objective", "9", "--split", "train",
                 "--save_dir", train_dir], log_path)
            fold_result["train"] = read_metrics(train_dir)
        summary["folds"][f"{fold}:{args.voc_tag}"] = fold_result
        summary_path.write_text(json.dumps(summary, indent=2))
        print(f"[loo] fold {fold} done: "
              + json.dumps(fold_result["heldout"]["objective_mean"]),
              flush=True)

    print(f"[loo] all folds done -> {summary_path}", flush=True)


if __name__ == "__main__":
    main()
