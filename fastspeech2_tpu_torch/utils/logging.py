"""TensorBoard + plaintext logging (port of
``fastspeech2_tpu/utils/logging.py``; reference utils/tools.py:69-88,
train.py:53-58,99-111 layout: Loss/{total,mel,mel_postnet,pitch,energy,
duration} scalars, mel figures, audio samples, mirrored log.txt lines).

``tensorboardX`` is imported when the logger is made, never at import.  A
host without it gets one line saying so, and the logger then writes each
figure as ``<log_path>/<tag>.png`` and each audio sample as
``<log_path>/<tag>.wav`` (tags with "/" replaced by "_"); the scalars are
the loss lines already in log.txt.  tensorboardX's audio needs
``soundfile``; without it the audio samples go to .wav files the same way,
after one line.  No duty is dropped without a line.
"""

import os

import numpy as np


class TrainLogger:
    def __init__(self, log_path, log=print):
        os.makedirs(log_path, exist_ok=True)
        self.log_path = log_path
        self.log = log
        self.audio_to_files = False
        self.text_log = os.path.join(log_path, "log.txt")
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self.writer = None
            log(f"tensorboardX is not installed: {log_path} gets log.txt, "
                "and the figures and audio samples as .png and .wav files")
        else:
            self.writer = SummaryWriter(log_path)

    def _file(self, tag, ext):
        return os.path.join(self.log_path, tag.replace("/", "_") + ext)

    def scalars(self, step, losses):
        names = ["total_loss", "mel_loss", "mel_postnet_loss", "pitch_loss",
                 "energy_loss", "duration_loss"]
        if self.writer is not None:
            for name, value in zip(names, losses):
                self.writer.add_scalar(f"Loss/{name}", float(value), step)

    def figure(self, tag, fig, step=None):
        if self.writer is not None:
            self.writer.add_figure(tag, fig, step)
        else:
            fig.savefig(self._file(tag, ".png"))

    def audio(self, tag, wav, sampling_rate, step=None):
        wav = np.asarray(wav, np.float32)
        wav = wav / max(abs(wav.min()), abs(wav.max()), 1)
        if self.writer is not None and not self.audio_to_files:
            try:
                self.writer.add_audio(tag, wav, step,
                                      sample_rate=sampling_rate)
                return
            except ImportError as e:
                self.audio_to_files = True
                self.log(f"tensorboardX cannot write audio ({e}): the audio "
                         f"samples go to .wav files in {self.log_path}")
        from scipy.io import wavfile

        wavfile.write(self._file(tag, ".wav"), sampling_rate, wav)

    def message(self, text):
        with open(self.text_log, "a") as f:
            f.write(text + "\n")

    def close(self):
        if self.writer is not None:
            self.writer.close()
