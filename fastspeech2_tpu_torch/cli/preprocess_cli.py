"""Data preparation CLIs (port of ``fastspeech2_tpu/cli/preprocess_cli.py``):

    python -m fastspeech2_tpu_torch.cli.preprocess_cli PRE.yaml \\
        [--align [--phones_file F]] [--mfa] [--device cuda|cpu]
    python -m fastspeech2_tpu_torch.cli.preprocess_cli prepare_align PRE.yaml

The first writes the training features (mel, pitch, energy, duration,
stats.json, speakers.json, train.txt and val.txt) from raw_path's wavs and
preprocessed_path's TextGrids; ``--align`` makes those TextGrids first
with the port's forced aligner (cli/align_cli.py), ``--mfa`` with the
Montreal Forced Aligner where it is installed.  The second writes
raw_path/<speaker>/{*.wav,*.lab} from the corpus (reference preprocess.py
and prepare_align.py).  The DSP and the aligner run on the card unless
``--device cpu`` is given.
"""

import argparse
import sys

import yaml

from fastspeech2_tpu_torch.utils.device import resolve_device


def _read_config(path):
    with open(path) as f:
        return yaml.safe_load(f)


def preprocess_main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str,
                        help="path to preprocess.yaml")
    parser.add_argument("--mfa", action="store_true",
                        help="run Montreal Forced Aligner first (must be "
                             "installed) to produce the TextGrid/ inputs")
    parser.add_argument("--mfa_acoustic_model", default="english_us_arpa")
    parser.add_argument("--mfa_dictionary", default=None)
    parser.add_argument("--align", action="store_true",
                        help="run the port's forced aligner first "
                             "(cli/align_cli.py; no external tools) to "
                             "produce the TextGrid/ inputs")
    parser.add_argument("--phones_file", default=None,
                        help="with --align: metadata file supplying "
                             "known phone sequences")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    config = _read_config(args.config)
    if args.align:
        from fastspeech2_tpu_torch.cli.align_cli import align_corpus

        align_corpus(config, phones_file=args.phones_file, device=device)
    if args.mfa:
        from fastspeech2_tpu_torch.preprocessing.mfa import run_mfa_align

        out_dir, _ = run_mfa_align(
            config, acoustic_model=args.mfa_acoustic_model,
            dictionary=args.mfa_dictionary)
        print(f"MFA alignment written to {out_dir}")
    from fastspeech2_tpu_torch.preprocessing.preprocessor import Preprocessor

    return Preprocessor(config, device).build_from_path()


def prepare_align_main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str,
                        help="path to preprocess.yaml")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; the adapters resample "
                             "on the host, so the flag only checks the "
                             "device as every entry point does")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    config = _read_config(args.config)
    from fastspeech2_tpu_torch.preprocessing.corpora import PREPARE_ALIGN

    dataset = config["dataset"]
    if dataset not in PREPARE_ALIGN:
        raise SystemExit(
            f"unknown dataset {dataset!r}; supported: "
            f"{sorted(PREPARE_ALIGN)}")
    PREPARE_ALIGN[dataset](config)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["prepare_align"]:
        return prepare_align_main(argv[1:])
    return preprocess_main(argv)


if __name__ == "__main__":
    main()
