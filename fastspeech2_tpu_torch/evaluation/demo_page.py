"""Generate an A/B listening page (port of
``fastspeech2_tpu/evaluation/demo_page.py``; the reference publishes demo/
+ index.html, this builds the equivalent from local wav pairs).  Host
only: no model runs here.

    python -m fastspeech2_tpu_torch.evaluation.demo_page \
        --out demo_out --title "Copy-synthesis, 26k-step vocoder" \
        gt1.wav:syn1.wav gt2.wav:syn2.wav

Each PAIR is "reference.wav:synthesized.wav"; both files are copied into
--out and an index.html with side-by-side players is written there.
"""

import argparse
import html
import os
import shutil

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
body {{ font-family: sans-serif; max-width: 56rem; margin: 2rem auto; }}
table {{ border-collapse: collapse; width: 100%; }}
td, th {{ padding: .6rem .8rem; border-bottom: 1px solid #ddd;
          text-align: left; }}
audio {{ width: 16rem; }}
</style></head><body>
<h1>{title}</h1>
<p>{subtitle}</p>
<table>
<tr><th>utterance</th><th>reference</th><th>synthesized</th></tr>
{rows}
</table></body></html>
"""

_ROW = ("<tr><td>{name}</td>"
        '<td><audio controls src="{ref}"></audio></td>'
        '<td><audio controls src="{syn}"></audio></td></tr>')


def write_demo_page(pairs, out_dir, title="Audio demo", subtitle=""):
    """pairs: [(ref_wav_path, syn_wav_path)] -> path of index.html."""
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for idx, (ref, syn) in enumerate(pairs):
        name = os.path.splitext(os.path.basename(ref))[0]
        # index prefix: same-basename pairs from different dirs must not
        # overwrite each other
        ref_dst = f"{idx:02d}_{name}_ref.wav"
        syn_dst = f"{idx:02d}_{name}_syn.wav"
        shutil.copyfile(ref, os.path.join(out_dir, ref_dst))
        shutil.copyfile(syn, os.path.join(out_dir, syn_dst))
        rows.append(_ROW.format(name=html.escape(name), ref=ref_dst,
                                syn=syn_dst))
    path = os.path.join(out_dir, "index.html")
    with open(path, "w") as f:
        f.write(_PAGE.format(title=html.escape(title),
                             subtitle=html.escape(subtitle),
                             rows="\n".join(rows)))
    return path


_TTS_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
body {{ font-family: sans-serif; max-width: 64rem; margin: 2rem auto; }}
table {{ border-collapse: collapse; width: 100%; }}
td, th {{ padding: .6rem .8rem; border-bottom: 1px solid #ddd;
          text-align: left; vertical-align: top; }}
audio {{ width: 15rem; }}
.text {{ color: #333; font-size: .92rem; max-width: 24rem; }}
.metrics {{ color: #666; font-size: .85rem; white-space: nowrap; }}
</style></head><body>
<h1>{title}</h1>
<p>{subtitle}</p>
<table>
<tr><th>utterance / input text</th><th>ground truth</th>
<th>text&rarr;wav (this framework)</th><th>objective</th></tr>
{rows}
</table>{footer}</body></html>
"""

_TTS_ROW = ("<tr><td><b>{name}</b><div class=\"text\">{text}</div></td>"
            '<td><audio controls src="{ref}"></audio></td>'
            '<td><audio controls src="{syn}"></audio></td>'
            '<td class="metrics">{metrics}</td></tr>')


def write_tts_demo_page(entries, out_dir, title="Text-to-speech demo",
                        subtitle="", footer_html=""):
    """Full text->wav A/B page with input text and objective metrics.

    entries: [{"name", "text", "ref" (wav path), "syn" (wav path),
    "metrics" ({label: value})}] — wavs are copied into out_dir.  This is
    the native equivalent of the reference's published demo/index.html
    (synthesized-vs-GT players), plus the text and measured-quality
    columns the reference lacks."""
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for idx, e in enumerate(entries):
        ref_dst = f"{idx:02d}_{e['name']}_gt.wav"
        syn_dst = f"{idx:02d}_{e['name']}_tts.wav"
        shutil.copyfile(e["ref"], os.path.join(out_dir, ref_dst))
        shutil.copyfile(e["syn"], os.path.join(out_dir, syn_dst))
        metrics = "<br>".join(
            f"{html.escape(str(k))}: {html.escape(str(v))}"
            for k, v in e.get("metrics", {}).items())
        rows.append(_TTS_ROW.format(
            name=html.escape(e["name"]), text=html.escape(e.get("text", "")),
            ref=ref_dst, syn=syn_dst, metrics=metrics))
    path = os.path.join(out_dir, "index.html")
    with open(path, "w") as f:
        f.write(_TTS_PAGE.format(
            title=html.escape(title), subtitle=html.escape(subtitle),
            rows="\n".join(rows), footer=footer_html))
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pairs", nargs="*",
                    help='each "reference.wav:synthesized.wav"')
    ap.add_argument("--out", required=True)
    ap.add_argument("--title", default="Audio demo")
    ap.add_argument("--subtitle", default="")
    ap.add_argument("--tts_metrics", default=None,
                    help="metrics.json from evaluate_cli --objective "
                         "--save_dir: build the full text->wav page "
                         "(needs --gt_dir and --syn_dir)")
    ap.add_argument("--gt_dir", default=None,
                    help="directory of <name>.wav ground-truth files")
    ap.add_argument("--syn_dir", default=None,
                    help="directory of <name>_tts.wav synthesized files")
    args = ap.parse_args(argv)
    if args.tts_metrics:
        import json

        with open(args.tts_metrics) as f:
            data = json.load(f)
        entries = []
        for r in data["rows"]:
            entries.append({
                "name": r["name"], "text": r.get("raw_text", ""),
                "ref": os.path.join(args.gt_dir, f"{r['name']}.wav"),
                "syn": os.path.join(args.syn_dir, f"{r['name']}_tts.wav"),
                "metrics": {k: v for k, v in r.items()
                            if k not in ("name", "raw_text")},
            })
        path = write_tts_demo_page(entries, args.out, args.title,
                                   args.subtitle)
        print(f"Wrote {path} ({len(entries)} utterances)")
        return path
    pairs = [tuple(p.split(":", 1)) for p in args.pairs]
    path = write_demo_page(pairs, args.out, args.title, args.subtitle)
    print(f"Wrote {path} ({len(pairs)} pairs)")
    return path


if __name__ == "__main__":
    main()
