"""Corpus preprocessing: MFA TextGrids + wavs -> training features (port of
``fastspeech2_tpu/preprocessing/preprocessor.py``).

Reproduces the reference pipeline (preprocessor/preprocessor.py:16-314):
per utterance, read the "phones" alignment tier, trim surrounding silences,
round interval edges to mel frames for durations, slice the wav, estimate
F0 (DIO + StoneMask, audio/dio.py, the default; YIN through
`preprocessing.pitch.estimator: yin`), compute mel+energy with the
TacotronSTFT equivalent (audio/stft.py), linearly interpolate unvoiced F0,
average pitch/energy per phoneme, write .npy features; then corpus-wide
mean/std normalization with IQR-outlier-free min/max into stats.json,
speakers.json, and shuffled train/val metadata splits.

The DSP (mel, energy, F0) runs on ``device``, the card unless the caller
asks for the CPU.  Wavs are padded to 32768-sample buckets (reflected past
their true end) as in the JAX package, and
`preprocessing.dsp_batch_size: N` stacks up to N same-bucket wavs into one
[N, L] batch on the device, which gives the per-utterance path's numbers.
"""

import json
import os
import random

import numpy as np

import torch

from fastspeech2_tpu_torch.audio.dio import dio_f0
from fastspeech2_tpu_torch.audio.f0 import interpolate_unvoiced, yin_f0
from fastspeech2_tpu_torch.audio.stft import MelSpectrogram
from fastspeech2_tpu_torch.audio.wav import load_wav
from fastspeech2_tpu_torch.preprocessing.textgrid import read_textgrid

SIL_PHONES = ["sil", "sp", "spn"]


class OnlineScaler:
    """Running mean/std (StandardScaler.partial_fit equivalent)."""

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def update(self, values):
        values = np.asarray(values, dtype=np.float64).ravel()
        if values.size == 0:
            return
        n_b = values.size
        mean_b = values.mean()
        var_b = values.var()
        n = self.n + n_b
        delta = mean_b - self.mean
        self.m2 += var_b * n_b + delta ** 2 * self.n * n_b / n
        self.mean += delta * n_b / n
        self.n = n

    @property
    def std(self):
        return np.sqrt(self.m2 / self.n) if self.n else 1.0


def remove_outliers(values):
    """IQR-filter (reference preprocessor/preprocessor.py:293-301)."""
    values = np.asarray(values)
    if values.size == 0:
        return values
    p25, p75 = np.percentile(values, [25, 75])
    lower = p25 - 1.5 * (p75 - p25)
    upper = p75 + 1.5 * (p75 - p25)
    return values[np.logical_and(values > lower, values < upper)]


class Preprocessor:
    def __init__(self, config, device="cuda"):
        self.config = config
        self.device = torch.device(device)
        self.in_dir = config["path"]["raw_path"]
        self.out_dir = config["path"]["preprocessed_path"]
        pp = config["preprocessing"]
        self.val_size = pp["val_size"]
        self.sampling_rate = pp["audio"]["sampling_rate"]
        self.hop_length = pp["stft"]["hop_length"]
        assert pp["pitch"]["feature"] in ["phoneme_level", "frame_level"]
        assert pp["energy"]["feature"] in ["phoneme_level", "frame_level"]
        self.pitch_phoneme_averaging = (
            pp["pitch"]["feature"] == "phoneme_level")
        self.energy_phoneme_averaging = (
            pp["energy"]["feature"] == "phoneme_level")
        self.pitch_normalization = pp["pitch"]["normalization"]
        self.energy_normalization = pp["energy"]["normalization"]
        # F0 estimator: "dio" = DIO+StoneMask (the reference's pyworld
        # algorithm, preprocessor/preprocessor.py:182-187), "yin" = YIN
        self.f0_estimator = pp["pitch"].get("estimator", "dio")
        assert self.f0_estimator in ("dio", "yin"), self.f0_estimator
        # optionally persist the silence-trimmed waveform (frame-aligned to
        # the mel) for vocoder training/fine-tuning
        self.save_trimmed_wav = bool(
            pp["audio"].get("save_trimmed_wav", False))
        # >1: stack same-bucket wavs into one batch on the device
        self.dsp_batch_size = int(pp.get("dsp_batch_size", 1))
        self.mel_fn = MelSpectrogram(
            filter_length=pp["stft"]["filter_length"],
            hop_length=pp["stft"]["hop_length"],
            win_length=pp["stft"]["win_length"],
            n_mel_channels=pp["mel"]["n_mel_channels"],
            sampling_rate=pp["audio"]["sampling_rate"],
            mel_fmin=pp["mel"]["mel_fmin"],
            mel_fmax=pp["mel"]["mel_fmax"] or self.sampling_rate / 2,
        )

    # ------------------------------------------------------------------

    def build_from_path(self):
        subdirs = ["mel", "pitch", "energy", "duration"]
        if self.save_trimmed_wav:
            subdirs.append("wav")
        for sub in subdirs:
            os.makedirs(os.path.join(self.out_dir, sub), exist_ok=True)

        out = []
        n_frames = 0
        pitch_scaler, energy_scaler = OnlineScaler(), OnlineScaler()
        speakers = {}

        # same-bucket prepared utterances awaiting a stacked DSP dispatch
        pending = {}                     # padded_len -> [prep, ...]

        def _consume(ret):
            nonlocal n_frames
            if ret is None:
                return
            info, pitch, energy, n = ret
            out.append(info)
            if len(pitch) > 0:
                pitch_scaler.update(pitch)
            if len(energy) > 0:
                energy_scaler.update(energy)
            n_frames += n

        def _flush(preps):
            # a partial group runs at its own batch size: the JAX package
            # pads it (one compiled [B, L] shape per bucket), torch need not
            pitch_b, mel_b, energy_b = self._dsp_batch(
                [p["wav_padded"] for p in preps])
            for j, p in enumerate(preps):
                _consume(self._finalize_utterance(
                    p, pitch_b[j], mel_b[j], energy_b[j]))

        for i, speaker in enumerate(sorted(os.listdir(self.in_dir))):
            spk_dir = os.path.join(self.in_dir, speaker)
            if not os.path.isdir(spk_dir):
                continue
            speakers[speaker] = i
            for wav_name in sorted(os.listdir(spk_dir)):
                if not wav_name.endswith(".wav"):
                    continue
                basename = wav_name[:-4]
                tg_path = os.path.join(
                    self.out_dir, "TextGrid", speaker,
                    f"{basename}.TextGrid")
                if not os.path.exists(tg_path):
                    continue
                if self.dsp_batch_size <= 1:
                    _consume(self.process_utterance(speaker, basename))
                    continue
                prep = self._prepare_utterance(speaker, basename)
                if prep is None:
                    continue
                key = len(prep["wav_padded"])
                pending.setdefault(key, []).append(prep)
                if len(pending[key]) >= self.dsp_batch_size:
                    _flush(pending.pop(key))
        for preps in pending.values():
            _flush(preps)

        pitch_mean = pitch_scaler.mean if self.pitch_normalization else 0.0
        pitch_std = pitch_scaler.std if self.pitch_normalization else 1.0
        energy_mean = energy_scaler.mean if self.energy_normalization else 0.0
        energy_std = energy_scaler.std if self.energy_normalization else 1.0

        pitch_min, pitch_max = self._normalize_dir(
            os.path.join(self.out_dir, "pitch"), pitch_mean, pitch_std)
        energy_min, energy_max = self._normalize_dir(
            os.path.join(self.out_dir, "energy"), energy_mean, energy_std)

        with open(os.path.join(self.out_dir, "speakers.json"), "w") as f:
            json.dump(speakers, f)
        with open(os.path.join(self.out_dir, "stats.json"), "w") as f:
            json.dump({
                "pitch": [float(pitch_min), float(pitch_max),
                          float(pitch_mean), float(pitch_std)],
                "energy": [float(energy_min), float(energy_max),
                           float(energy_mean), float(energy_std)],
            }, f)

        print("Total time: {:.2f} hours".format(
            n_frames * self.hop_length / self.sampling_rate / 3600))

        random.shuffle(out)
        with open(os.path.join(self.out_dir, "train.txt"), "w",
                  encoding="utf-8") as f:
            for m in out[self.val_size:]:
                f.write(m + "\n")
        with open(os.path.join(self.out_dir, "val.txt"), "w",
                  encoding="utf-8") as f:
            for m in out[:self.val_size]:
                f.write(m + "\n")
        return out

    # ------------------------------------------------------------------

    def _prepare_utterance(self, speaker, basename):
        """Host-side pass: alignment, trim, wav slice, bucket padding.
        Returns a dict of everything the device DSP and finalize need."""
        wav_path = os.path.join(self.in_dir, speaker, f"{basename}.wav")
        text_path = os.path.join(self.in_dir, speaker, f"{basename}.lab")
        tg_path = os.path.join(
            self.out_dir, "TextGrid", speaker, f"{basename}.TextGrid")

        textgrid = read_textgrid(tg_path)
        phones, durations, start, end = self.get_alignment(
            textgrid.get_tier_by_name("phones"))
        text = "{" + " ".join(phones) + "}"
        if start >= end:
            return None

        wav, _ = load_wav(wav_path, target_sr=self.sampling_rate)
        wav = wav[int(self.sampling_rate * start):
                  int(self.sampling_rate * end)]
        total = int(sum(durations))

        with open(text_path) as f:
            raw_text = f.readline().strip("\n")

        # pad the wav to a coarse bucket, as the JAX package does for its
        # jitted mel/F0 functions (trailing frames are sliced away via
        # [:total])
        bucket = 32768
        padded_len = ((len(wav) + bucket - 1) // bucket) * bucket
        wav_padded = np.zeros(padded_len, dtype=wav.dtype)
        wav_padded[: len(wav)] = wav
        # reflect past the true end so boundary frames match the unpadded
        # centered-STFT values (reference reflect-pads, audio/stft.py:60-65)
        n_fft = self.mel_fn.filter_length
        tail = min(n_fft, padded_len - len(wav), len(wav) - 1)
        if tail > 0:
            wav_padded[len(wav): len(wav) + tail] = wav[-2: -tail - 2: -1]
        return {
            "speaker": speaker, "basename": basename, "text": text,
            "raw_text": raw_text, "durations": durations, "total": total,
            "wav": wav, "wav_padded": wav_padded,
        }

    def _dsp_batch(self, wavs_padded):
        """[B, L] padded wavs -> (pitch [B, F], mel [B, n_mels, F],
        energy [B, F]) as numpy, computed as one batch on the device."""
        stacked = torch.as_tensor(
            np.stack(wavs_padded).astype(np.float32), device=self.device)
        f0_fn = dio_f0 if self.f0_estimator == "dio" else yin_f0
        pitch = f0_fn(stacked, self.sampling_rate, self.hop_length)
        mel, energy = self.mel_fn(stacked)
        return tuple(t.cpu().numpy() for t in (pitch, mel, energy))

    def _finalize_utterance(self, prep, pitch, mel, energy):
        """Host-side pass: slice to true frames, interp/average, save."""
        speaker, basename = prep["speaker"], prep["basename"]
        durations, total = prep["durations"], prep["total"]
        wav = prep["wav"]
        pitch = pitch[:total]
        if np.sum(pitch != 0) <= 1:
            return None
        mel = mel[:, :total]                             # [n_mels, T]
        energy = energy[:total]

        if self.pitch_phoneme_averaging:
            pitch = interpolate_unvoiced(pitch)
            pitch = _phoneme_average(pitch, durations)
        if self.energy_phoneme_averaging:
            energy = _phoneme_average(energy, durations)

        np.save(os.path.join(self.out_dir, "duration",
                             f"{speaker}-duration-{basename}.npy"),
                np.asarray(durations))
        np.save(os.path.join(self.out_dir, "pitch",
                             f"{speaker}-pitch-{basename}.npy"), pitch)
        np.save(os.path.join(self.out_dir, "energy",
                             f"{speaker}-energy-{basename}.npy"), energy)
        np.save(os.path.join(self.out_dir, "mel",
                             f"{speaker}-mel-{basename}.npy"), mel.T)
        if self.save_trimmed_wav:
            # exactly total*hop samples so wav[i*hop:(i+1)*hop] pairs with
            # mel frame i during vocoder (fine-)tuning
            n_samples = total * self.hop_length
            aligned = np.zeros(n_samples, np.float32)
            src = np.asarray(wav[:n_samples], np.float32)
            aligned[: len(src)] = src
            np.save(os.path.join(self.out_dir, "wav",
                                 f"{speaker}-wav-{basename}.npy"), aligned)

        return (
            "|".join([basename, speaker, prep["text"], prep["raw_text"]]),
            remove_outliers(pitch),
            remove_outliers(energy),
            mel.shape[1],
        )

    def process_utterance(self, speaker, basename):
        """Single-utterance path (prepare -> one-row DSP -> finalize)."""
        prep = self._prepare_utterance(speaker, basename)
        if prep is None:
            return None
        pitch, mel, energy = self._dsp_batch([prep["wav_padded"]])
        return self._finalize_utterance(prep, pitch[0], mel[0], energy[0])

    # ------------------------------------------------------------------

    def get_alignment(self, tier):
        """Silence-trimmed phones + frame-rounded durations
        (reference preprocessor/preprocessor.py:253-291)."""
        phones, durations = [], []
        start_time = end_time = 0.0
        end_idx = 0
        for iv in tier.intervals:
            s, e, p = iv.start_time, iv.end_time, iv.text
            if not phones:
                if p in SIL_PHONES or p == "":
                    continue
                start_time = s
            if p == "":
                p = "sp"  # MFA emits empty text for short pauses
            if p not in SIL_PHONES:
                phones.append(p)
                end_time = e
                end_idx = len(phones)
            else:
                phones.append(p)
            durations.append(int(
                np.round(e * self.sampling_rate / self.hop_length)
                - np.round(s * self.sampling_rate / self.hop_length)))
        return phones[:end_idx], durations[:end_idx], start_time, end_time

    def _normalize_dir(self, in_dir, mean, std):
        max_value, min_value = np.finfo(np.float64).min, np.finfo(
            np.float64).max
        for filename in os.listdir(in_dir):
            path = os.path.join(in_dir, filename)
            values = (np.load(path) - mean) / std
            np.save(path, values)
            if values.size:
                max_value = max(max_value, values.max())
                min_value = min(min_value, values.min())
        return min_value, max_value


def _phoneme_average(values, durations):
    """Mean of frame values per phoneme
    (reference preprocessor/preprocessor.py:209-228)."""
    values = np.asarray(values, dtype=np.float64).copy()
    pos = 0
    for i, d in enumerate(durations):
        if d > 0:
            values[i] = np.mean(values[pos: pos + d])
        else:
            values[i] = 0.0
        pos += d
    return values[: len(durations)]
