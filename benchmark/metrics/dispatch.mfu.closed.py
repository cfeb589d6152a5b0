"""The model FLOPs of the utterances answered inside the window, each at
its own phone count and frames (wav samples / hop): one FastSpeech 2
forward and one vocoder forward (benchmark/harness/flops.py), over the
window's seconds times the dense TF32 peak of one H100 (the
configuration computes in float32), in percent."""

import os

from benchmark.harness import flops
from benchmark.harness.texts import TextGen
from benchmark.reference import frontend


def read(ctx):
    cell = ctx["cell"]
    cfg = cell.config
    lex_path = os.path.join(cell.root, cfg["preprocess"]["path"][
        "lexicon_path"])
    gen = TextGen(cell.traffic["texts"], lex_path, ctx["seed"])
    lex = frontend.read_lexicon(lex_path)
    hop = cfg["audio"]["hop_length"]
    total = 0.0
    for r in ctx["done"]:
        P = len(frontend.text_to_ids(gen.text(r["id"]), lex))
        T = r["samples"] // hop
        total += (flops.acoustic_flops(P, T, cfg["arch"])
                  + flops.vocoder_flops(T, cfg["vocoder"],
                                        cfg["arch"]["n_mel_channels"]))
    seconds = ctx["t1"] - ctx["t0"]
    return 100.0 * total / (seconds * flops.PEAK_FLOPS[cfg["dtype"]]) \
        if total else None
