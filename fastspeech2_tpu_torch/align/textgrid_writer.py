"""Write Praat long-format TextGrids from alignment durations (a copy of
``fastspeech2_tpu/align/textgrid_writer.py``, which is pure Python).

Produces exactly what the Preprocessor consumes (a "phones" interval
tier, preprocessing/textgrid.py + reference
preprocessor/preprocessor.py:163-167): interval edges on exact mel-frame
boundaries (k * hop / sr seconds), so the preprocessor's frame rounding
(reference preprocessor/preprocessor.py:282-287) reproduces the aligner's
integer durations bit-for-bit.
"""

import os


def _esc(text):
    return text.replace('"', '""')


def write_textgrid(path, phones, durations, hop_length, sampling_rate,
                   tier_name="phones"):
    """phones: list[str]; durations: list[int] mel frames (same length).

    Zero-duration tokens (skipped optional silences) are omitted — MFA
    likewise never emits empty intervals.
    """
    assert len(phones) == len(durations)
    edges = [0]
    for d in durations:
        edges.append(edges[-1] + int(d))
    t = [e * hop_length / sampling_rate for e in edges]
    intervals = [
        (t[i], t[i + 1], phones[i])
        for i in range(len(phones)) if durations[i] > 0
    ]
    xmax = t[-1]
    lines = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "",
        "xmin = 0",
        f"xmax = {xmax:.10f}",
        "tiers? <exists>",
        "size = 1",
        "item []:",
        "    item [1]:",
        '        class = "IntervalTier"',
        f'        name = "{_esc(tier_name)}"',
        "        xmin = 0",
        f"        xmax = {xmax:.10f}",
        f"        intervals: size = {len(intervals)}",
    ]
    for i, (s, e, p) in enumerate(intervals, 1):
        lines += [
            f"        intervals [{i}]:",
            f"            xmin = {s:.10f}",
            f"            xmax = {e:.10f}",
            f'            text = "{_esc(p)}"',
        ]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return path
