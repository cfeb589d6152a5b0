"""What the harness takes from the system under test
(``fastspeech2_tpu_torch``): its server and trainer built as its CLIs
build them, and hooks that record what its dispatches return.  Nothing
here is imported before a run has checked for its device."""

import json
import os
import time

import numpy as np
import yaml


def write_yaml_configs(config, work, root):
    """The configuration's preprocess, model and train dicts -> yaml files
    under ``work`` (the preprocessed path there, with the configuration's
    corpus statistics; the lexicon under ``root``) -> their three
    paths."""
    pre = dict(config["preprocess"])
    pre["path"] = dict(pre["path"])
    pre_dir = os.path.join(work, "preprocessed")
    os.makedirs(pre_dir, exist_ok=True)
    with open(os.path.join(pre_dir, "stats.json"), "w") as f:
        json.dump(config["stats"], f)
    with open(os.path.join(pre_dir, "speakers.json"), "w") as f:
        json.dump(config["speakers"], f)
    pre["path"]["preprocessed_path"] = pre_dir
    pre["path"]["lexicon_path"] = os.path.join(root, pre["path"][
        "lexicon_path"])
    train = dict(config["train"])
    train["path"] = {k: os.path.join(work, k) for k in
                     ("ckpt_path", "log_path", "result_path")}
    paths = []
    for name, body in (("preprocess", pre), ("model", config["model"]),
                       ("train", train)):
        path = os.path.join(work, name + ".yaml")
        with open(path, "w") as f:
            yaml.safe_dump(body, f)
        paths.append(path)
    return paths


class DispatchRecorder:
    """Wraps ``Synthesizer.synthesize_ids`` on one instance: every
    dispatch's host times and real rows' frames, and per sentence (keyed
    by its phone IDs) the continuous predictions and rounded durations it
    returned and the text length its dispatch padded it to.

    The wrapper adds no wait for the device and no host buffer: the
    dispatch's outputs are cloned on the device behind its own work on the
    same stream (the next dispatch's replay, which overwrites them, queues
    behind the clones), and copied to the host once the run asks for
    ``records`` or ``dispatches``, after the window."""

    def __init__(self, synthesizer):
        self.syn = synthesizer
        self.orig = synthesizer.synthesize_ids
        self._records = {}
        self._dispatches = []       # (t0, t1, each row's frames)
        self.pending = []
        synthesizer.synthesize_ids = self

    def __call__(self, id_seqs, *args, **kwargs):
        t0 = time.monotonic()
        wavs, out = self.orig(id_seqs, *args, **kwargs)
        t1 = time.monotonic()
        parts = [t.detach().clone() for t in (
            out.log_duration_prediction, out.pitch_prediction,
            out.energy_prediction, out.duration_rounded,
            out.mel_len[:len(id_seqs)])]
        keys = [tuple(int(x) for x in ids) for ids in id_seqs]
        self.pending.append((t0, t1, keys, parts))
        return wavs, out

    def _flush(self):
        for t0, t1, keys, parts in self.pending:
            log_d, pitch, energy, dur, mel_len = (
                t.float().cpu().numpy() for t in parts)
            self._dispatches.append((t0, t1, [int(t) for t in mel_len]))
            for i, key in enumerate(keys):
                if key not in self._records:
                    P = len(key)
                    self._records[key] = {
                        "log_duration": log_d[i, :P], "pitch": pitch[i, :P],
                        "energy": energy[i, :P],
                        "duration": dur[i, :P].astype(np.int64),
                        "padded": int(log_d.shape[1])}
        self.pending = []

    @property
    def records(self):
        self._flush()
        return self._records

    @property
    def dispatches(self):
        self._flush()
        return self._dispatches

    def restore(self):
        self.syn.synthesize_ids = self.orig
