"""The README sentence's acoustic forward on the tracked full-size weights,
held against the JAX package's float32 result of the same forward.

    python -m fastspeech2_tpu_torch.tools.readme_reference [--device cpu]

The JAX result is committed as ``reference_data/readme_sentence_jax.npz``
(``tests/test_torch_repairs.py`` makes it anew from the JAX package and
requires it to be equal).  It holds the phone IDs, the rounded durations,
the phone-level pitch and energy predictions before bucketize, their bucket
ids (``searchsorted(side="left")`` on the float32 bins) and the mel after
the PostNet over the spoken frames.  The forward runs with no vocoder.
"""

import argparse
import os

import numpy as np
import torch

CONFIG = "config/LJSpeech10"
ACOUSTIC_NPZ = "weights/acoustic_LJSpeech10_100k.npz"
README_SENTENCE = "The quick brown fox jumps over the lazy dog."
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "reference_data", "readme_sentence_jax.npz")
# a bucket id may differ from JAX's only where JAX's value before bucketize
# lies this close to a bin edge
BOUNDARY_MARGIN = 1e-4
FIELDS = ("ids", "durations", "pitch_prediction", "energy_prediction",
          "pitch_bucket", "energy_bucket", "postnet_mel")


def record(ids, out, pitch_bins, energy_bins):
    """A forward's output (either package's, as numpy arrays) -> the
    fixture's fields for its first row."""
    durations = np.asarray(out["durations"])[0, : len(ids)]
    mel_len = int(np.asarray(out["mel_len"])[0])
    rec = dict(ids=np.asarray(ids, np.int64),
               durations=durations.astype(np.int64),
               postnet_mel=np.asarray(out["postnet_mel"], np.float32)[
                   0, :mel_len])
    for name, bins in (("pitch", pitch_bins), ("energy", energy_bins)):
        pred = np.asarray(out[f"{name}_prediction"], np.float32)[0, : len(ids)]
        rec[f"{name}_prediction"] = pred
        rec[f"{name}_bucket"] = np.searchsorted(
            np.asarray(bins, np.float32), pred, side="left").astype(np.int64)
    return rec


def margins(pred, bins):
    """|value - nearest bin edge| of each value."""
    bins = np.asarray(bins, np.float64)
    return np.abs(np.asarray(pred, np.float64)[:, None]
                  - bins[None, :]).min(axis=1)


def port_forward(device="cuda", dtype=torch.float32):
    """The port's forward of the README sentence -> (record, the bins)."""
    from fastspeech2_tpu_torch.cli.synthesize_cli import (
        load_model_for_inference,
    )
    from fastspeech2_tpu_torch.configs.config import load_yaml_configs
    from fastspeech2_tpu_torch.synthesis.pipeline import Synthesizer

    pre, model_cfg, _ = load_yaml_configs(
        f"{CONFIG}/preprocess.yaml", f"{CONFIG}/model.yaml",
        f"{CONFIG}/train.yaml")
    model, cfg = load_model_for_inference(pre, model_cfg, ACOUSTIC_NPZ,
                                          device, dtype=dtype)
    synth = Synthesizer(model, cfg, pre, device)
    ids, _ = synth.text_to_ids(README_SENTENCE)
    out = synth.infer_ids([ids])
    adaptor = model.variance_adaptor
    bins = (adaptor.pitch_bins.cpu().numpy(),
            adaptor.energy_bins.cpu().numpy())
    arrays = dict(durations=out.duration_rounded.cpu().numpy(),
                  mel_len=out.mel_len.cpu().numpy(),
                  postnet_mel=out.postnet_mel.float().cpu().numpy(),
                  pitch_prediction=out.pitch_prediction.float().cpu().numpy(),
                  energy_prediction=out.energy_prediction.float().cpu()
                  .numpy())
    return record(ids, arrays, *bins), bins


def load_fixture(path=FIXTURE):
    with np.load(path) as f:
        return {k: f[k] for k in FIELDS}


def compare(got, ref, bins):
    """-> a report of ``got`` against the fixture ``ref``: IDs and
    durations equal, each bucket id that differs with its margin, and the
    mel's largest difference over the frames both speak."""
    report = dict(ids_equal=bool(np.array_equal(got["ids"], ref["ids"])))
    report["durations_equal"] = bool(
        report["ids_equal"]
        and np.array_equal(got["durations"], ref["durations"]))
    flips = {}
    near_edge = True
    for name, edges in zip(("pitch", "energy"), bins):
        if not report["ids_equal"]:
            break
        diff = np.nonzero(got[f"{name}_bucket"] != ref[f"{name}_bucket"])[0]
        m = margins(ref[f"{name}_prediction"], edges)
        flips[name] = [(int(i), float(m[i])) for i in diff]
        near_edge = near_edge and all(m[i] < BOUNDARY_MARGIN for i in diff)
    report["bucket_flips"] = flips
    report["flips_near_edge"] = near_edge
    n = min(len(got["postnet_mel"]), len(ref["postnet_mel"]))
    report["mel_frames"] = (len(got["postnet_mel"]), len(ref["postnet_mel"]))
    report["mel_max_abs_diff"] = float(np.abs(
        got["postnet_mel"][:n] - ref["postnet_mel"][:n]).max())
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    from fastspeech2_tpu_torch.utils.device import resolve_device

    got, bins = port_forward(resolve_device(args.device))
    report = compare(got, load_fixture(), bins)
    print(report)
    return report


if __name__ == "__main__":
    main()
