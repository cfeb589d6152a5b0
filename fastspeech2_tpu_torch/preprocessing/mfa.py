"""Montreal Forced Aligner integration (a copy of
``fastspeech2_tpu/preprocessing/mfa.py``, which builds a command line).

The reference leaves alignment as a manual external step (its README
instructs running `mfa align` by hand and unpacking TextGrids into
preprocessed_data/<ds>/TextGrid/).  This wraps that step: when the `mfa`
binary is installed it is invoked on the prepare_align output
(raw_path/<speaker>/{*.wav,*.lab}) and the resulting TextGrids land where
the Preprocessor expects them; when it is not installed, a precise
instruction string is raised so the manual workflow still works.
"""

import os
import shutil
import subprocess


class MFANotInstalled(RuntimeError):
    pass


def mfa_binary():
    return shutil.which("mfa")


def run_mfa_align(config, acoustic_model="english_us_arpa",
                  dictionary=None, num_jobs=4, binary=None, runner=None):
    """raw_path corpus -> <preprocessed_path>/TextGrid via `mfa align`.

    dictionary defaults to the configured lexicon_path.  `runner` is
    injectable for tests (defaults to subprocess.run).
    """
    binary = binary or mfa_binary()
    raw_path = config["path"]["raw_path"]
    out_dir = os.path.join(
        config["path"]["preprocessed_path"], "TextGrid")
    dictionary = dictionary or config["path"].get("lexicon_path")
    if binary is None:
        raise MFANotInstalled(
            "Montreal Forced Aligner not found on PATH. Install it "
            "(conda install -c conda-forge montreal-forced-aligner) or run "
            "manually:\n"
            f"  mfa align {raw_path} {dictionary} {acoustic_model} "
            f"{out_dir}\n"
            "then re-run the preprocess CLI."
        )
    os.makedirs(out_dir, exist_ok=True)
    cmd = [binary, "align", raw_path, str(dictionary), acoustic_model,
           out_dir, "-j", str(num_jobs), "--clean"]
    runner = runner or subprocess.run
    result = runner(cmd, check=True)
    return out_dir, result
