"""Text -> waveform synthesis (port of
``fastspeech2_tpu/synthesis/pipeline.py``).

Phone IDs padded to a (batch, text) bucket -> one acoustic forward at the
default frame length (max_mel_len, max_seq_len unless given) -> a
re-dispatch at round_up(need, 512) frames with decoder truncation off when
the predicted length exceeds it -> the vocoder -> int16 wavs trimmed to
mel_len * hop.  Per utterance the results are a trimmed wav and a
mel/F0/energy png (save_results writes ``<id>.wav`` and ``<id>.png``; the
png needs matplotlib).  :meth:`Synthesizer.synthesize_long` splits a long
text into sentences, synthesizes them as one batch and joins them with
short pauses.

With the vocoders the JAX package fuses (the HiFi-GAN generators and
MelGAN; ``:112-142``), :meth:`Synthesizer.synthesize` is one fused
dispatch, the acoustic forward and then the vocoder on the padded mel,
with the five controls as 0-d float32 tensors.  On the card it is a CUDA
graph per (batch bucket, text bucket) that :meth:`Synthesizer.warm_shape`
made warm (``synthesis/graphs.py``); a shape without a graph is dispatched
eagerly and does not become warm (a capture costs more than a one-shot
dispatch: JAX has to compile, the port need not), nor does the
extended-length re-dispatch.  Griffin-Lim keeps the unfused
path.

Serving mode (``snap_to_warm``): each dispatch pads UP to the smallest warm
(batch bucket, text bucket) shape that covers it (``_snap``), so that with
the top shape warmed no request waits for a capture.  Snapping is an
argument of each packing, not a flag that :meth:`Synthesizer.warm_shape`
switches off while it runs: a warmup in a background thread never
un-snaps a concurrent request (the JAX package toggles the shared flag,
``:219``).

Replicas (``devices``, the serve CLI's ``--data_parallel``): one copy of
the acoustic model and the vocoder per device, in one process, as the JAX
package shards a dispatch over a data mesh (``:46-74``).  The batch bucket
rounds up to a multiple of the replica count, each replica takes its
contiguous rows, and the wavs are gathered on the first device.  The
PostNet zeroes the frames past the *whole* batch's max mel length
(fastspeech2_tpu/models/fastspeech2.py:142-149), so each replica runs its
acoustic front (``FastSpeech2.front``) first, the batch's max is taken
over all of them, and then each runs its PostNet against that max and its
vocoder: a replica that used its own rows' max would change its shorter
rows' tails.  On the card each replica has its own graph cache over its
front, with its own lock, memory pool and capture stream (two replicas
may share a card), keyed by the replica's (rows, text) shape; the
PostNet and vocoder run eagerly after the batch's max is known.
"""

import copy
import json
import os
import re
import threading
import wave

import numpy as np
import torch

from fastspeech2_tpu_torch.models.hifigan import HiFiGANGenerator
from fastspeech2_tpu_torch.models.hifigan_istft import HiFiGANiSTFTGenerator
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2Output
from fastspeech2_tpu_torch.synthesis.graphs import GraphCache, kernel_counts
from fastspeech2_tpu_torch.synthesis.plotting import (
    expand_by_duration,
    plot_mel,
    plot_stats,
)
from fastspeech2_tpu_torch.synthesis.vocoder import MelGANVocoder, vocoder_infer
from fastspeech2_tpu_torch.text import text_to_sequence
from fastspeech2_tpu_torch.text.g2p import (
    english_to_phones,
    make_oov_to_phones,
    mandarin_to_phones,
    read_lexicon,
)

TEXT_BUCKET = 16   # phone IDs pad to a multiple of this by default
# the vocoders of the fused text->wav dispatch (``raw_apply`` in the JAX
# package)
FUSED_VOCODERS = (HiFiGANGenerator, HiFiGANiSTFTGenerator, MelGANVocoder)


def round_up(n, multiple):
    return ((int(n) + multiple - 1) // multiple) * multiple


class _Replica:
    """One device's copy of the acoustic model and the vocoder, its graph
    cache over the acoustic front (on the card, with a fused vocoder), and
    the kernel launches of its eager work."""

    def __init__(self, model, vocoder, device, graphs, max_mel_len):
        self.model = model
        self.max_mel_len = max_mel_len
        self.vocoder = vocoder
        self.device = torch.device(device)
        self.launches = dict.fromkeys(kernel_counts(), 0)
        self.graphs = (GraphCache(self.front, self.device)
                       if graphs and self.device.type == "cuda" else None)

    def front(self, speakers, texts, src_lens, p, e, d, p_off, e_off,
              max_mel_len=None, truncate_decoder=True):
        out = self.model.front(
            speakers, texts, src_lens,
            max_mel_len=max_mel_len or self.max_mel_len, p_control=p,
            e_control=e, d_control=d, p_offset=p_off, e_offset=e_off,
            truncate_decoder=truncate_decoder)
        return out.mel, out


class Synthesizer:
    def __init__(self, model, config, preprocess_config, device, vocoder=None,
                 control_mode="reference", max_mel_len=None,
                 text_bucket=TEXT_BUCKET, snap_to_warm=False, devices=None):
        """model: a FastSpeech2 in eval mode on ``device``.

        control_mode: "reference" scales the predicted (z-normalised)
        pitch/energy, the reference's semantics; "absolute" scales the
        denormalised value (p_control=1.2 means +20% F0), using the corpus
        stats.json: z' = r*z + (r-1)*mean/std.

        snap_to_warm: serving mode (module docstring); off by default, as
        one-shot callers prefer exact shapes.

        devices: two or more devices to replicate the model and vocoder
        over (module docstring); the first is ``device``.
        """
        self.model = model
        self.config = config
        self.preprocess_config = preprocess_config
        self.device = torch.device(device)
        self.vocoder = vocoder
        self.max_mel_len = max_mel_len or config.max_seq_len
        self.text_bucket = text_bucket
        self.control_mode = control_mode
        self.snap_to_warm = snap_to_warm
        self._lexicon = None
        self._oov_to_phones = None
        self._stats = None
        # warm-shape registry: {(batch bucket, text bucket)} dispatched at
        # the default frame length (on the card with the fused vocoders:
        # the shapes warm_shape captured a graph of)
        self._warm = set()
        self._warm_lock = threading.Lock()
        self.fused = isinstance(vocoder, FUSED_VOCODERS)
        self.replicas = []
        if devices is not None and len(devices) > 1:
            if torch.device(devices[0]) != next(model.parameters()).device:
                raise ValueError(f"devices[0] {devices[0]} is not the "
                                 f"model's device")
            self.replicas = [
                _Replica(model if i == 0 else copy.deepcopy(model).to(dev),
                         vocoder if i == 0 or vocoder is None
                         else copy.deepcopy(vocoder).to(dev), dev,
                         self.fused, self.max_mel_len)
                for i, dev in enumerate(devices)]
        self.graphs = (GraphCache(self._forward_to_wav, self.device)
                       if self.fused and self.device.type == "cuda"
                       and not self.replicas else None)

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

    def _pack_batch(self, id_seqs, speakers, snap=False):
        """Pad phone IDs to a (batch, text) bucket: the batch rounds up to a
        power of two, the text to a multiple of text_bucket; with ``snap``
        both grow to the smallest warm shape that covers them.  Padding rows
        duplicate row 0, so batch-max quantities (the PostNet frame mask,
        the re-dispatch length) are unchanged; callers slice per-sample
        outputs with the real batch count."""
        B = len(id_seqs)
        Bb = round_up(max(1, 1 << (B - 1).bit_length()),
                      max(1, len(self.replicas)))
        P = round_up(max(len(s) for s in id_seqs), self.text_bucket)
        if snap:
            Bb, P = self._snap(Bb, P)
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

    def _snap(self, Bb, P):
        """Smallest warm (batch, text) shape covering (Bb, P), ranked by
        text width first (the frame length is fixed, so extra text columns
        only grow the encoder), else (Bb, P) itself, which its dispatch
        then makes warm (on the card with a fused vocoder, only
        warm_shape makes a shape warm)."""
        with self._warm_lock:
            if (Bb, P) in self._warm:
                return Bb, P
            covering = [(p, b) for (b, p) in self._warm
                        if b >= Bb and p >= P]
        if covering:
            p, b = min(covering)
            return b, p
        return Bb, P

    def _mark_warm(self, texts_shape):
        """Record a dispatched (batch, text) shape as warm."""
        with self._warm_lock:
            self._warm.add((int(texts_shape[0]), int(texts_shape[1])))

    def warm_shape(self, batch, phones):
        """Make the exact (batch, text bucket) shape warm: dummy phone IDs
        at the padded shape through the path requests take (on the card
        with a fused vocoder: capture its graph), never snapped."""
        P = round_up(max(1, phones), self.text_bucket)
        ids = [np.ones(P, np.int64)] * max(1, batch)
        if not self.fused:
            self._infer_ids(ids, None, 1.0, 1.0, 1.0, snap=False)
            return
        speakers, texts, src_lens = self._pack_batch(ids, None)
        if self.replicas:
            for rep, rows in zip(self.replicas,
                                 self._split(speakers, texts, src_lens)):
                if rep.graphs is not None:
                    rep.graphs.capture(*rows)
            if self.replicas[0].graphs is None:
                self._replicated(speakers, texts, src_lens,
                                 (1.0, 1.0, 1.0, 0.0, 0.0))
        elif self.graphs is not None:
            self.graphs.capture(speakers, texts, src_lens)
        else:
            self.fused_forward(speakers, texts, src_lens,
                               (1.0, 1.0, 1.0, 0.0, 0.0))
        self._mark_warm(texts.shape)

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
        return self._infer_ids(id_seqs, speakers, p_control, e_control,
                               d_control, snap=self.snap_to_warm)

    def _infer_ids(self, id_seqs, speakers, p_control, e_control, d_control,
                   snap):
        p_off, e_off = self._control_offsets(p_control, e_control)
        speakers, texts, src_lens = self._pack_batch(id_seqs, speakers, snap)

        def forward(max_mel_len, truncate_decoder):
            if self.replicas:
                return self._replicated(
                    speakers, texts, src_lens,
                    (p_control, e_control, d_control, p_off, e_off),
                    max_mel_len, truncate_decoder, vocode=False)[1]
            with torch.inference_mode():
                return self.model(
                    speakers, texts, src_lens, max_mel_len=max_mel_len,
                    p_control=p_control, e_control=e_control,
                    d_control=d_control, p_offset=p_off, e_offset=e_off,
                    truncate_decoder=truncate_decoder)

        out = forward(self.max_mel_len, True)
        self._mark_warm(texts.shape)
        # unclipped predicted frames: duration_rounded is never truncated
        need = int(out.duration_rounded.sum(dim=1).max())
        if need > self.max_mel_len:
            out = forward(round_up(need, 512), False)
        return out

    def fused_forward(self, speakers, texts, src_lens, controls,
                      max_mel_len=None, truncate_decoder=True):
        """One eager fused text->wav forward: the acoustic model, then the
        vocoder on the padded postnet mel (upcast for the HiFi-GAN
        generators, at its dtype for MelGAN, as ``vocoder_infer`` feeds
        them).  controls: (p, e, d, p_offset, e_offset), made 0-d float32
        tensors -> (float32 wav [B, frames * hop], FastSpeech2Output)."""
        controls = [torch.tensor(float(c), dtype=torch.float32,
                                 device=self.device) for c in controls]
        with torch.inference_mode():
            return self._forward_to_wav(speakers, texts, src_lens, *controls,
                                        max_mel_len, truncate_decoder)

    def _forward_to_wav(self, speakers, texts, src_lens, p, e, d, p_off,
                        e_off, max_mel_len=None, truncate_decoder=True):
        """The fused forward on control tensors (what a graph captures)."""
        out = self.model(speakers, texts, src_lens,
                         max_mel_len=max_mel_len or self.max_mel_len,
                         p_control=p, e_control=e, d_control=d, p_offset=p_off,
                         e_offset=e_off, truncate_decoder=truncate_decoder)
        mel = out.postnet_mel
        if not isinstance(self.vocoder, MelGANVocoder):
            mel = mel.float()
        return self.vocoder(mel).float(), out

    def _split(self, *arrays):
        """Each replica's contiguous rows of the packed arrays, on its
        device."""
        b = arrays[0].shape[0] // len(self.replicas)
        return [[a[i * b:(i + 1) * b].to(rep.device) for a in arrays]
                for i, rep in enumerate(self.replicas)]

    def _replicated(self, speakers, texts, src_lens, controls,
                    max_mel_len=None, truncate_decoder=True, vocode=True):
        """The dispatch over the replicas -> (float32 wav or None,
        FastSpeech2Output), gathered on the first device.  Each replica's
        front (its graph's replay where it has one at the default frame
        length), then the batch's max mel length, then each replica's
        PostNet against it and its vocoder."""
        max_mel_len = max_mel_len or self.max_mel_len
        default_len = max_mel_len == self.max_mel_len and truncate_decoder
        fronts = []
        with torch.inference_mode():
            for rep, rows in zip(self.replicas,
                                 self._split(speakers, texts, src_lens)):
                if (default_len and rep.graphs is not None
                        and rows[1].shape in rep.graphs):
                    fronts.append(rep.graphs.run(*rows, controls)[1])
                    continue
                start = kernel_counts()
                ctl = [torch.tensor(float(c), dtype=torch.float32,
                                    device=rep.device) for c in controls]
                fronts.append(rep.front(*rows, *ctl, max_mel_len,
                                        truncate_decoder)[1])
                self._count(rep, start)
            batch_max = torch.stack([o.mel_len.max().to(self.device)
                                     for o in fronts]).max()
            outs, wavs = [], []
            for rep, out in zip(self.replicas, fronts):
                start = kernel_counts()
                out = rep.model.with_postnet(out, batch_max.to(rep.device))
                if vocode:
                    mel = out.postnet_mel
                    if not isinstance(rep.vocoder, MelGANVocoder):
                        mel = mel.float()
                    wavs.append(rep.vocoder(mel).float().to(self.device))
                self._count(rep, start)
                outs.append(out)
            out = FastSpeech2Output(*(torch.cat([t.to(self.device)
                                                 for t in parts])
                                      for parts in zip(*outs)))
        return (torch.cat(wavs) if vocode else None), out

    @staticmethod
    def _count(rep, start):
        for k, v in kernel_counts().items():
            rep.launches[k] += v - start[k]

    def replica_launches(self):
        """-> per replica {kernel: launches}: its eager work's counts plus
        its graphs' replays (``GraphCache.launches``)."""
        out = []
        for rep in self.replicas:
            graphs = (rep.graphs.launches() if rep.graphs is not None
                      else dict.fromkeys(rep.launches, 0))
            out.append({k: rep.launches[k] + graphs[k] for k in rep.launches})
        return out

    def synthesize_ids(self, id_seqs, speakers=None, p_control=1.0,
                       e_control=1.0, d_control=1.0):
        """The fused text->wav dispatch of phone-ID arrays -> (list of int16
        wavs, FastSpeech2Output); snapped to a warm shape in serving mode,
        a graph replay where the shape has one.  A predicted length beyond
        max_mel_len is dispatched again at round_up(need, 512) frames,
        untruncated and eagerly."""
        B = len(id_seqs)
        p_off, e_off = self._control_offsets(p_control, e_control)
        controls = (p_control, e_control, d_control, p_off, e_off)
        speakers, texts, src_lens = self._pack_batch(id_seqs, speakers,
                                                     self.snap_to_warm)
        if self.replicas:
            wav, out = self._replicated(speakers, texts, src_lens, controls)
            if self.replicas[0].graphs is None:
                self._mark_warm(texts.shape)
        elif self.graphs is not None and texts.shape in self.graphs:
            wav, out = self.graphs.run(speakers, texts, src_lens, controls)
        else:
            wav, out = self.fused_forward(speakers, texts, src_lens,
                                          controls)
            if self.graphs is None:
                self._mark_warm(texts.shape)
        need = int(out.duration_rounded.sum(dim=1).max())
        if need > self.max_mel_len and self.replicas:
            wav, out = self._replicated(
                speakers, texts, src_lens, controls,
                max_mel_len=round_up(need, 512), truncate_decoder=False)
        elif need > self.max_mel_len:
            wav, out = self.fused_forward(
                speakers, texts, src_lens, controls,
                max_mel_len=round_up(need, 512), truncate_decoder=False)
        pp = self.preprocess_config["preprocessing"]
        hop = pp["stft"]["hop_length"]
        wavs = np.clip(wav.cpu().numpy() * pp["audio"]["max_wav_value"],
                       -32768, 32767).astype(np.int16)
        mel_len = out.mel_len.cpu().numpy()
        return [wavs[i, : int(mel_len[i]) * hop] for i in range(B)], out

    def synthesize(self, texts, speakers=None, p_control=1.0, e_control=1.0,
                   d_control=1.0):
        """list of raw strings -> (list of int16 wavs, FastSpeech2Output)."""
        id_seqs = [self.text_to_ids(t)[0] for t in texts]
        if self.fused:
            return self.synthesize_ids(id_seqs, speakers, p_control,
                                       e_control, d_control)
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
