"""Training/eval data pipeline with fixed-shape bucketed batching (a copy
of ``fastspeech2_tpu/data/dataset.py``, numpy only, reading the port's own
``text/``).

Reads the same on-disk artifact layout as the reference
(preprocessed_path/{mel,pitch,energy,duration}/<spk>-<kind>-<base>.npy plus
pipe-delimited train.txt/val.txt and speakers.json; dataset.py:12-146) and
reproduces its grouped-sorted batching: shuffle, take group_size*batch_size
items, sort by text length descending, split into group_size batches
(train.py:31-38, dataset.py:127-146).

Every batch is padded to BUCKETED static shapes (text and mel lengths
rounded up to fixed edges), as in the JAX package, so both packages see
the same batches for the same seed.
"""

import json
import os

import numpy as np

from fastspeech2_tpu_torch.text import text_to_sequence


def round_up(n, multiple):
    return ((int(n) + multiple - 1) // multiple) * multiple


class FeatureDataset:
    """Random-access view over a preprocessed corpus split."""

    def __init__(self, metadata_file, preprocess_config):
        self.preprocessed_path = preprocess_config["path"]["preprocessed_path"]
        self.cleaners = preprocess_config["preprocessing"]["text"][
            "text_cleaners"]
        path = (metadata_file if os.path.isabs(metadata_file)
                else os.path.join(self.preprocessed_path, metadata_file))
        self.basename, self.speaker, self.text, self.raw_text = (
            self._read_metadata(path))
        with open(os.path.join(self.preprocessed_path, "speakers.json")) as f:
            self.speaker_map = json.load(f)
        self._phone_cache = {}

    @staticmethod
    def _read_metadata(path):
        names, speakers, texts, raws = [], [], [], []
        with open(path, encoding="utf-8") as f:
            for line in f:
                n, s, t, r = line.rstrip("\n").split("|")
                names.append(n)
                speakers.append(s)
                texts.append(t)
                raws.append(r)
        return names, speakers, texts, raws

    def __len__(self):
        return len(self.basename)

    def phones(self, idx):
        if idx not in self._phone_cache:
            self._phone_cache[idx] = np.asarray(
                text_to_sequence(self.text[idx], self.cleaners),
                dtype=np.int32)
        return self._phone_cache[idx]

    def _feature(self, kind, idx):
        fname = "{}-{}-{}.npy".format(
            self.speaker[idx], kind, self.basename[idx])
        return np.load(os.path.join(self.preprocessed_path, kind, fname))

    def __getitem__(self, idx):
        return {
            "id": self.basename[idx],
            "speaker": self.speaker_map[self.speaker[idx]],
            "raw_text": self.raw_text[idx],
            "text": self.phones(idx),
            "mel": self._feature("mel", idx),
            "pitch": self._feature("pitch", idx),
            "energy": self._feature("energy", idx),
            "duration": self._feature("duration", idx).astype(np.int32),
        }


def collate_batch(samples, text_bucket=8, mel_bucket=32, max_mel_len=None):
    """Pad a list of samples into one fixed-shape numpy batch dict."""
    B = len(samples)
    P = round_up(max(len(s["text"]) for s in samples), text_bucket)
    T_raw = max(s["mel"].shape[0] for s in samples)
    T = round_up(T_raw, mel_bucket)
    if max_mel_len is not None:
        T = min(T, round_up(max_mel_len, mel_bucket))
    n_mels = samples[0]["mel"].shape[1]
    var_is_phone = samples[0]["pitch"].shape[0] == samples[0]["duration"].shape[0]
    V = P if var_is_phone else T

    batch = {
        "ids": [s["id"] for s in samples],
        "raw_texts": [s["raw_text"] for s in samples],
        "speakers": np.zeros(B, np.int32),
        "texts": np.zeros((B, P), np.int32),
        "src_lens": np.zeros(B, np.int32),
        "mels": np.zeros((B, T, n_mels), np.float32),
        "mel_lens": np.zeros(B, np.int32),
        "pitches": np.zeros((B, V), np.float32),
        "energies": np.zeros((B, V), np.float32),
        "durations": np.zeros((B, P), np.int32),
    }
    for b, s in enumerate(samples):
        p = len(s["text"])
        t = min(s["mel"].shape[0], T)
        batch["speakers"][b] = s["speaker"]
        batch["texts"][b, :p] = s["text"]
        batch["src_lens"][b] = p
        batch["mels"][b, :t] = s["mel"][:t]
        batch["mel_lens"][b] = t
        v = min(len(s["pitch"]), V)
        batch["pitches"][b, :v] = s["pitch"][:v]
        e = min(len(s["energy"]), V)
        batch["energies"][b, :e] = s["energy"][:e]
        batch["durations"][b, :p] = s["duration"][:p]
    return batch


class BucketedLoader:
    """Grouped-sorted batch iterator with static bucket shapes."""

    def __init__(self, dataset, batch_size, group_size=4, shuffle=True,
                 drop_last=False, seed=0, text_bucket=8, mel_bucket=32,
                 max_mel_len=None, shard_id=0, num_shards=1):
        """shard_id/num_shards: multi-host data parallelism — every host
        builds the same global shuffle and takes every num_shards-th batch,
        so per-host streams are disjoint and equally long (lockstep-safe)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.group_size = group_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.text_bucket = text_bucket
        self.mel_bucket = mel_bucket
        self.max_mel_len = max_mel_len
        self.shard_id = shard_id
        self.num_shards = num_shards
        self._text_lens = np.array(
            [len(dataset.phones(i)) for i in range(len(dataset))])

    def _total_batches(self, n):
        group = self.batch_size * self.group_size
        total = 0
        for start in range(0, n, group):
            size = min(group, n - start)
            full, rem = divmod(size, self.batch_size)
            total += full + (0 if self.drop_last or rem == 0 else 1)
        return total

    def epoch(self, epoch_idx=0):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + epoch_idx)
            rng.shuffle(order)
        group = self.batch_size * self.group_size
        batch_no = -1
        # equal-length shards for multi-host lockstep
        per_shard_cap = (self._total_batches(n) // self.num_shards
                         if self.num_shards > 1 else None)
        yielded = 0
        for start in range(0, n, group):
            chunk = order[start: start + group]
            # sort by text length desc inside the group (dataset.py:129-131)
            chunk = chunk[np.argsort(-self._text_lens[chunk])]
            for bstart in range(0, len(chunk), self.batch_size):
                idxs = chunk[bstart: bstart + self.batch_size]
                if self.drop_last and len(idxs) < self.batch_size:
                    continue
                batch_no += 1
                if self.num_shards > 1 and (
                        batch_no % self.num_shards != self.shard_id):
                    continue
                if per_shard_cap is not None and yielded >= per_shard_cap:
                    return
                yielded += 1
                samples = [self.dataset[i] for i in idxs]
                if not self.drop_last and len(idxs) < self.batch_size:
                    # pad batch to full size by repeating the last sample so
                    # shapes stay static; repeated rows are flagged
                    pad_count = self.batch_size - len(idxs)
                    samples = samples + [samples[-1]] * pad_count
                    batch = collate_batch(
                        samples, self.text_bucket, self.mel_bucket,
                        self.max_mel_len)
                    batch["valid_count"] = len(idxs)
                    yield batch
                    continue
                batch = collate_batch(
                    samples, self.text_bucket, self.mel_bucket,
                    self.max_mel_len)
                batch["valid_count"] = len(idxs)
                yield batch

    def __iter__(self):
        return self.epoch(0)
