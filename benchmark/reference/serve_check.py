"""The serving cells' comparison of served replies with the reference.

For each sampled request (a text the server takes on its short path, one
dispatch) the reference works out the phone IDs from the text, then the
FastSpeech 2 forward and the vocoder in float32 with TF32 off.  Each
text runs at the text length its
dispatch padded it to: the variance predictors' second convolution reads
the first's output at the padded phones, so the predictions of a text's
last phones depend on that length.  Durations, pitch and energy buckets
are discrete: a
product rounded differently can move a value across a rounding edge and a
whole stretch of frames with it.  So the reference takes the system's own
rounded durations and pitch/energy values (which pick the buckets) as its
teacher-forced inputs, after holding each to its own continuous value:

- ``pred_gap``: the largest |system - reference| over every phone's
  log-duration, pitch and energy prediction;
- ``dur_slack``: how far a system duration lies beyond the rounding of
  the reference's exp(log d) - 1 (0 where it is one of the two nearest
  whole numbers within 0.5);
- ``wav_rel_rms``: the largest, over the sampled requests, of the RMS of
  (served int16 wav - reference int16 wav) over the reference's RMS,
  outside the text's last ``tail`` frames (which depend on the
  batch-mates of its dispatch);
- ``ids_mismatch``, ``len_mismatch``: requests whose phone IDs, or whose
  wav's length, differ from the reference's (limit 0).
"""

import numpy as np
import torch

from benchmark.reference import frontend
from benchmark.reference.fs2 import Model
from benchmark.reference.vocoder import generate


def tail_frames(cfg, vcfg):
    """Frames at a row's end whose samples may depend on its batch-mates:
    the PostNet's radius (its frame mask is at the batch's longest mel)
    spread by the vocoder's (conv_pre, each stage's transposed conv and
    widest ResBlock, conv_post and the iSTFT's overlap, at their rates)."""
    radius = cfg["postnet_n_convolutions"] * (cfg["postnet_kernel_size"]
                                              - 1) / 2
    radius += 3
    rate = 1
    for u, k in zip(vcfg["upsample_rates"], vcfg["upsample_kernel_sizes"]):
        radius += -(-k // u) / rate
        rate *= u
        radius += max(sum((rk - 1) // 2 * (d + 1) for d in dils)
                      for rk, dils in zip(vcfg["resblock_kernel_sizes"],
                                          vcfg["resblock_dilation_sizes"])
                      ) / rate
    radius += 3 / rate
    radius += vcfg["gen_istft_n_fft"] / vcfg["gen_istft_hop_size"] / rate
    return int(np.ceil(radius))


def to_int16(wav, max_wav_value):
    return np.clip(wav * max_wav_value, -32768, 32767).astype(np.int16)


class Checker:
    def __init__(self, acoustic, cfg, voc, vcfg, lexicon, audio):
        self.model = Model(acoustic, cfg)
        self.voc, self.vcfg = voc, vcfg
        self.lexicon = lexicon
        self.hop = audio["hop_length"]
        self.max_wav = audio["max_wav_value"]
        self.tail = tail_frames(cfg, vcfg)
        self.long_chars = audio["long_chars"]

    @torch.no_grad()
    def sentence(self, ids, rec, device):
        """One sentence against the system's record -> (int16 wav,
        pred gap, duration slack)."""
        P, pad = len(ids), rec["padded"]

        def t(a, dt):
            row = np.zeros(pad, np.float64)
            row[:P] = np.asarray(a)[:P]
            return torch.as_tensor(row[None], dtype=dt, device=device)

        d = t(rec["duration"], torch.long)
        T = int(d.sum())
        out = self.model.forward(
            t(ids, torch.long), torch.tensor([P], device=device), max(T, 1), d,
            t(rec["pitch"], torch.float32), t(rec["energy"], torch.float32),
            truncate=False)
        gap = 0.0
        for key in ("log_duration", "pitch", "energy"):
            ref = out[key][0, :P].double().cpu().numpy()
            gap = max(gap, float(np.abs(ref - np.asarray(rec[key][:P],
                                                         np.float64)).max()))
        cont = np.exp(out["log_duration"][0, :P].double().cpu().numpy()) - 1.0
        sys_d = np.asarray(rec["duration"][:P], np.float64)
        slack = np.where(sys_d > 0, np.abs(cont - sys_d) - 0.5, cont - 0.5)
        wav = generate(self.voc, self.vcfg, out["postnet_mel"])[0, :T * self.hop]
        return (to_int16(wav.cpu().numpy(), self.max_wav), gap,
                float(max(0.0, slack.max())))

    def request(self, text, served, records, device):
        """One request -> dict of its numbers (None: IDs not found)."""
        if len(text) > self.long_chars:
            raise ValueError(f"{text!r} takes the server's long path, "
                             "which this comparison does not cover")
        ids = frontend.text_to_ids(text, self.lexicon)
        rec = records.get(tuple(ids))
        if rec is None:
            return {"ids_ok": False}
        ref, gap, slack = self.sentence(ids, rec, device)
        out = {"ids_ok": True, "len_ok": ref.size == served.size,
               "pred_gap": gap, "dur_slack": slack, "wav_rel_rms": None}
        idx = np.arange(max(0, ref.size - self.tail * self.hop))
        if out["len_ok"] and idx.size:
            r = ref[idx].astype(np.float64)
            p = served[idx].astype(np.float64)
            den = max(np.sqrt(np.mean(r * r)), 1.0)
            out["wav_rel_rms"] = float(np.sqrt(np.mean((p - r) ** 2)) / den)
        return out


def summarise(results, n_failed, limits):
    """Per-request results -> [(name, value, limit)] and whether every
    number is within its limit."""
    ids_bad = sum(1 for r in results if not r["ids_ok"])
    ok = [r for r in results if r["ids_ok"]]
    len_bad = sum(1 for r in ok if not r["len_ok"])
    gap = max((r["pred_gap"] for r in ok), default=0.0)
    slack = max((r["dur_slack"] for r in ok), default=0.0)
    compared = [r["wav_rel_rms"] for r in ok if r["wav_rel_rms"] is not None]
    rms = max(compared, default=0.0)
    checks = [("failed", n_failed, 0), ("ids_mismatch", ids_bad, 0),
              ("len_mismatch", len_bad, 0),
              ("pred_gap", gap, limits["pred_gap"]),
              ("dur_slack", slack, limits["dur_slack"]),
              ("wav_rel_rms", rms, limits["wav_rel_rms"])]
    # a run in which no wav was long enough to compare proves nothing
    correct = bool(compared) and all(v <= lim for _, v, lim in checks)
    return checks, correct
