"""Text -> waveform synthesis (port of
``fastspeech2_tpu/synthesis/pipeline.py``).

Phone IDs padded to a (batch, text) bucket -> one acoustic forward at the
default frame length (max_seq_len) -> a re-dispatch at round_up(need, 512)
frames with decoder truncation off when the predicted length exceeds it ->
the vocoder -> int16 wavs trimmed to mel_len * hop.  Per utterance the
results are a trimmed wav and a mel/F0/energy png (save_results writes
``<id>.wav`` and ``<id>.png``; the png needs matplotlib).
:meth:`Synthesizer.synthesize_long` splits a long text into sentences,
synthesizes them as one batch and joins them with short pauses.

Not ported here: the serving-only warm-shape snapping and the fused
acoustic+vocoder jit path of the JAX package (PyTorch runs eagerly; the
unfused path computes the same values).
"""

import json
import os
import re
import wave

import numpy as np
import torch

from fastspeech2_tpu_torch.synthesis.plotting import (
    expand_by_duration,
    plot_mel,
    plot_stats,
)
from fastspeech2_tpu_torch.synthesis.vocoder import vocoder_infer
from fastspeech2_tpu_torch.text import text_to_sequence
from fastspeech2_tpu_torch.text.g2p import (
    english_to_phones,
    make_oov_to_phones,
    mandarin_to_phones,
    read_lexicon,
)

TEXT_BUCKET = 16   # phone IDs pad to a multiple of this


def round_up(n, multiple):
    return ((int(n) + multiple - 1) // multiple) * multiple


class Synthesizer:
    def __init__(self, model, config, preprocess_config, device, vocoder=None,
                 control_mode="reference"):
        """model: a FastSpeech2 in eval mode on ``device``.

        control_mode: "reference" scales the predicted (z-normalised)
        pitch/energy, the reference's semantics; "absolute" scales the
        denormalised value (p_control=1.2 means +20% F0), using the corpus
        stats.json: z' = r*z + (r-1)*mean/std.
        """
        self.model = model
        self.config = config
        self.preprocess_config = preprocess_config
        self.device = torch.device(device)
        self.vocoder = vocoder
        self.max_mel_len = config.max_seq_len
        self.control_mode = control_mode
        self._lexicon = None
        self._oov_to_phones = None
        self._stats = None

    # -- text frontends --------------------------------------------------

    @property
    def lexicon(self):
        if self._lexicon is None:
            path = self.preprocess_config["path"]["lexicon_path"]
            self._lexicon = (read_lexicon(path)
                             if os.path.exists(path) else {})
        return self._lexicon

    def text_to_ids(self, text):
        pp = self.preprocess_config["preprocessing"]
        if pp["text"]["language"] == "zh":
            phones = mandarin_to_phones(text, self.lexicon)
        else:
            if self._oov_to_phones is None:
                self._oov_to_phones = make_oov_to_phones(self.device)
            phones = english_to_phones(text, self.lexicon,
                                       self._oov_to_phones)
        return np.asarray(
            text_to_sequence(phones, pp["text"]["text_cleaners"]),
            dtype=np.int64), phones

    # -- inference -------------------------------------------------------

    def _pack_batch(self, id_seqs, speakers):
        """Pad phone IDs to a (batch, text) bucket: the batch rounds up to a
        power of two, the text to a multiple of TEXT_BUCKET.  Padding rows
        duplicate row 0, so batch-max quantities (the PostNet frame mask,
        the re-dispatch length) are unchanged; callers slice per-sample
        outputs with the real batch count."""
        B = len(id_seqs)
        Bb = max(1, 1 << (B - 1).bit_length())
        P = round_up(max(len(s) for s in id_seqs), TEXT_BUCKET)
        texts = np.zeros((Bb, P), np.int64)
        src_lens = np.zeros(Bb, np.int64)
        for b in range(Bb):
            s = id_seqs[b] if b < B else id_seqs[0]
            texts[b, : len(s)] = s
            src_lens[b] = len(s)
        if speakers is None:
            spk = np.zeros(Bb, np.int64)
        else:
            spk = np.asarray(speakers, np.int64)
            spk = np.concatenate([spk, np.full(Bb - B, spk[0], np.int64)])
        return tuple(torch.as_tensor(a, device=self.device)
                     for a in (spk, texts, src_lens))

    def _control_offsets(self, p_control, e_control):
        """(p_offset, e_offset) for the active control_mode; only features
        the preprocessor z-scored get an offset."""
        if self.control_mode != "absolute":
            return 0.0, 0.0
        if self._stats is None:
            stats_path = os.path.join(
                self.preprocess_config["path"]["preprocessed_path"],
                "stats.json")
            with open(stats_path) as f:
                self._stats = json.load(f)
        pp = self.preprocess_config["preprocessing"]
        p_off = e_off = 0.0
        if pp["pitch"].get("normalization", False):
            mean, std = self._stats["pitch"][2:4]
            p_off = (p_control - 1.0) * mean / std
        if pp["energy"].get("normalization", False):
            mean, std = self._stats["energy"][2:4]
            e_off = (e_control - 1.0) * mean / std
        return p_off, e_off

    def infer_ids(self, id_seqs, speakers=None, p_control=1.0,
                  e_control=1.0, d_control=1.0):
        """id_seqs: list of int phone-ID arrays -> FastSpeech2Output.

        Utterances whose predicted length exceeds the default frame length
        are re-dispatched at round_up(need, 512) frames with decoder
        truncation OFF, the reference's eval behaviour
        (transformer/Models.py:82-87,145-151)."""
        p_off, e_off = self._control_offsets(p_control, e_control)
        speakers, texts, src_lens = self._pack_batch(id_seqs, speakers)

        def forward(max_mel_len, truncate_decoder):
            with torch.inference_mode():
                return self.model(
                    speakers, texts, src_lens, max_mel_len=max_mel_len,
                    p_control=p_control, e_control=e_control,
                    d_control=d_control, p_offset=p_off, e_offset=e_off,
                    truncate_decoder=truncate_decoder)

        out = forward(self.max_mel_len, True)
        # unclipped predicted frames: duration_rounded is never truncated
        need = int(out.duration_rounded.sum(dim=1).max())
        if need > self.max_mel_len:
            out = forward(round_up(need, 512), False)
        return out

    def synthesize(self, texts, speakers=None, p_control=1.0, e_control=1.0,
                   d_control=1.0):
        """list of raw strings -> (list of int16 wavs, FastSpeech2Output)."""
        id_seqs = [self.text_to_ids(t)[0] for t in texts]
        out = self.infer_ids(id_seqs, speakers, p_control, e_control,
                             d_control)
        wavs = None
        if self.vocoder is not None:
            # drop the batch-bucket padding rows (see _pack_batch)
            wavs = vocoder_infer(
                out.postnet_mel, self.vocoder, self.preprocess_config,
                lengths=out.mel_len.cpu().numpy())[: len(id_seqs)]
        return wavs, out

    def synthesize_long(self, text, speaker=0, p_control=1.0, e_control=1.0,
                        d_control=1.0, pause_ms=120.0):
        """Unlimited-length synthesis: split on sentence punctuation,
        synthesize the chunks as one batch, join them with ``pause_ms`` of
        silence -> (int16 wav, list of chunks)."""
        chunks = [c.strip() for c in
                  re.split(r"(?<=[.!?;:])\s+", text.strip()) if c.strip()]
        if not chunks:
            return np.zeros(0, np.int16), []
        speakers = np.full(len(chunks), speaker, np.int64)
        wavs, _ = self.synthesize(chunks, speakers, p_control, e_control,
                                  d_control)
        sr = self.preprocess_config["preprocessing"]["audio"][
            "sampling_rate"]
        pause = np.zeros(int(sr * pause_ms / 1000.0), np.int16)
        pieces = []
        for i, w in enumerate(wavs):
            pieces.append(w)
            if i < len(wavs) - 1:
                pieces.append(pause)
        return np.concatenate(pieces), chunks

    # -- result files ----------------------------------------------------

    def save_results(self, ids, out, wavs, result_path):
        """Write <id>.wav (16-bit mono PCM) and <id>.png (the mel with its
        F0 and energy, utils/tools.py:164-210) per utterance; returns the
        wav paths.  Without matplotlib the wavs are written, one line says
        the pngs were not drawn, and nothing else changes."""
        os.makedirs(result_path, exist_ok=True)
        pp = self.preprocess_config["preprocessing"]
        sr = pp["audio"]["sampling_rate"]
        paths = []
        if wavs is not None:
            for basename, wav in zip(ids, wavs):
                path = os.path.join(result_path, f"{basename}.wav")
                write_wav(path, sr, wav)
                paths.append(path)
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            print(f"matplotlib is not installed: {len(ids)} png(s) not "
                  f"drawn in {result_path}")
            return paths
        from matplotlib import pyplot as plt

        stats = plot_stats(self.preprocess_config)
        postnet_mel = out.postnet_mel.float().cpu().numpy()
        durations = out.duration_rounded.cpu().numpy()
        pitches = out.pitch_prediction.float().cpu().numpy()
        energies = out.energy_prediction.float().cpu().numpy()
        for i, basename in enumerate(ids):
            L, S = int(out.mel_len[i]), int(out.src_len[i])
            pitch, energy = pitches[i], energies[i]
            if pp["pitch"]["feature"] == "phoneme_level":
                pitch = expand_by_duration(pitch[:S], durations[i, :S])
            else:
                pitch = pitch[:L]
            if pp["energy"]["feature"] == "phoneme_level":
                energy = expand_by_duration(energy[:S], durations[i, :S])
            else:
                energy = energy[:L]
            fig = plot_mel([(postnet_mel[i, :L].T, pitch, energy)], stats,
                           ["Synthesized Spectrogram"])
            fig.savefig(os.path.join(result_path, f"{basename}.png"))
            plt.close(fig)
        return paths


def write_wav(path, sampling_rate, samples):
    """int16 numpy samples -> 16-bit mono PCM wav."""
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(int(sampling_rate))
        f.writeframes(np.asarray(samples, "<i2").tobytes())
