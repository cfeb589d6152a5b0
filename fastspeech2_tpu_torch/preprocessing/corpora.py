"""Corpus adapters: raw datasets -> raw_data/<speaker>/{*.wav, *.lab}
(port of ``fastspeech2_tpu/preprocessing/corpora.py`` on the port's own
text cleaners and wav reader).

Same normalization contract as the reference adapters: resample to the
config rate, peak-normalize, write int16 wavs and cleaned transcript .lab
files that MFA consumes.
  - LJSpeech: metadata.csv, single speaker (preprocessor/ljspeech.py:11-38)
  - AISHELL-3: content.txt, pinyin = every 2nd token, speaker = name[:7]
    (preprocessor/aishell3.py:8-34)
  - LibriTTS: *.normalized.txt walk (preprocessor/libritts.py:11-44)
"""

import os

import numpy as np
from scipy.io import wavfile

from fastspeech2_tpu_torch.audio.wav import load_wav
from fastspeech2_tpu_torch.text import _clean_text


def _write_norm_wav(src_path, dst_path, sampling_rate, max_wav_value):
    wav, _ = load_wav(src_path, target_sr=sampling_rate)
    peak = np.abs(wav).max()
    if peak > 0:
        wav = wav / peak * max_wav_value
    wavfile.write(dst_path, sampling_rate,
                  np.clip(wav, -32768, 32767).astype(np.int16))


def prepare_align_ljspeech(config):
    in_dir = config["path"]["corpus_path"]
    out_dir = config["path"]["raw_path"]
    pp = config["preprocessing"]
    sampling_rate = pp["audio"]["sampling_rate"]
    max_wav_value = pp["audio"]["max_wav_value"]
    cleaners = pp["text"]["text_cleaners"]
    speaker = "LJSpeech"
    with open(os.path.join(in_dir, "metadata.csv"), encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            base_name, text = parts[0], parts[2]
            text = _clean_text(text, cleaners)
            wav_path = os.path.join(in_dir, "wavs", f"{base_name}.wav")
            if not os.path.exists(wav_path):
                continue
            os.makedirs(os.path.join(out_dir, speaker), exist_ok=True)
            _write_norm_wav(
                wav_path, os.path.join(out_dir, speaker, f"{base_name}.wav"),
                sampling_rate, max_wav_value)
            with open(os.path.join(out_dir, speaker, f"{base_name}.lab"),
                      "w") as f1:
                f1.write(text)


def prepare_align_aishell3(config):
    in_dir = config["path"]["corpus_path"]
    out_dir = config["path"]["raw_path"]
    pp = config["preprocessing"]
    sampling_rate = pp["audio"]["sampling_rate"]
    max_wav_value = pp["audio"]["max_wav_value"]
    for dataset in ["train", "test"]:
        content = os.path.join(in_dir, dataset, "content.txt")
        if not os.path.exists(content):
            continue
        with open(content, encoding="utf-8") as f:
            for line in f:
                wav_name, text = line.strip("\n").split("\t")
                speaker = wav_name[:7]
                pinyin = text.split(" ")[1::2]  # hanzi/pinyin alternate
                wav_path = os.path.join(
                    in_dir, dataset, "wav", speaker, wav_name)
                if not os.path.exists(wav_path):
                    continue
                os.makedirs(os.path.join(out_dir, speaker), exist_ok=True)
                _write_norm_wav(
                    wav_path, os.path.join(out_dir, speaker, wav_name),
                    sampling_rate, max_wav_value)
                with open(os.path.join(out_dir, speaker,
                                       f"{wav_name[:11]}.lab"), "w") as f1:
                    f1.write(" ".join(pinyin))


def prepare_align_libritts(config):
    in_dir = config["path"]["corpus_path"]
    out_dir = config["path"]["raw_path"]
    pp = config["preprocessing"]
    sampling_rate = pp["audio"]["sampling_rate"]
    max_wav_value = pp["audio"]["max_wav_value"]
    cleaners = pp["text"]["text_cleaners"]
    for speaker in sorted(os.listdir(in_dir)):
        spk_dir = os.path.join(in_dir, speaker)
        if not os.path.isdir(spk_dir):
            continue
        for chapter in sorted(os.listdir(spk_dir)):
            ch_dir = os.path.join(spk_dir, chapter)
            if not os.path.isdir(ch_dir):
                continue
            for file_name in sorted(os.listdir(ch_dir)):
                if not file_name.endswith(".wav"):
                    continue
                base_name = file_name[:-4]
                text_path = os.path.join(
                    ch_dir, f"{base_name}.normalized.txt")
                if not os.path.exists(text_path):
                    continue
                with open(text_path) as f:
                    text = f.readline().strip("\n")
                text = _clean_text(text, cleaners)
                os.makedirs(os.path.join(out_dir, speaker), exist_ok=True)
                _write_norm_wav(
                    os.path.join(ch_dir, file_name),
                    os.path.join(out_dir, speaker, f"{base_name}.wav"),
                    sampling_rate, max_wav_value)
                with open(os.path.join(out_dir, speaker,
                                       f"{base_name}.lab"), "w") as f1:
                    f1.write(text)


PREPARE_ALIGN = {
    "LJSpeech": prepare_align_ljspeech,
    "AISHELL3": prepare_align_aishell3,
    "LibriTTS": prepare_align_libritts,
}
