"""Mel/pitch/energy plotting (port of
``fastspeech2_tpu/synthesis/plotting.py``; reference utils/tools.py:213-262
layout: mel image with the F0 contour on a left twin axis and energy on a
right twin axis, both de-normalized through stats.json).

matplotlib is imported inside :func:`plot_mel`, never at import: a host
without matplotlib still imports the port, and
``Synthesizer.save_results`` writes the wavs and skips the figure there.
"""

import json
import os

import numpy as np


def plot_stats(preprocess_config):
    """stats.json's [pitch min, max, mean, std, energy min, max] for
    :func:`plot_mel`, or the identity when the corpus has no stats.json."""
    path = os.path.join(preprocess_config["path"]["preprocessed_path"],
                        "stats.json")
    if not os.path.exists(path):
        return [0.0, 1.0, 0.0, 1.0, 0.0, 1.0]
    with open(path) as f:
        stats = json.load(f)
    return stats["pitch"] + stats["energy"][:2]


def expand_by_duration(values, durations):
    """Repeat each phoneme value by its duration (utils/tools.py:102-106)."""
    out = []
    for value, d in zip(values, durations):
        out += [value] * max(0, int(d))
    return np.array(out)


def plot_mel(data, stats, titles=None):
    """data: list of (mel [n_mels, T], pitch [T], energy [T]) tuples.

    stats: [pitch_min, pitch_max, pitch_mean, pitch_std, energy_min,
    energy_max] in normalized units.
    """
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    fig, axes = plt.subplots(len(data), 1, squeeze=False)
    if titles is None:
        titles = [None for _ in data]
    pitch_min, pitch_max, pitch_mean, pitch_std, energy_min, energy_max = (
        stats[:6])
    pitch_min = pitch_min * pitch_std + pitch_mean
    pitch_max = pitch_max * pitch_std + pitch_mean

    def add_axis(fig, old_ax):
        ax = fig.add_axes(old_ax.get_position(), anchor="W")
        ax.set_facecolor("None")
        return ax

    for i, (mel, pitch, energy) in enumerate(data):
        pitch = np.asarray(pitch) * pitch_std + pitch_mean
        axes[i][0].imshow(mel, origin="lower", aspect="auto")
        axes[i][0].set_ylim(0, mel.shape[0])
        axes[i][0].set_title(titles[i], fontsize="medium")
        axes[i][0].tick_params(labelsize="x-small",
                               left=False, labelleft=False)
        axes[i][0].set_anchor("W")

        ax1 = add_axis(fig, axes[i][0])
        ax1.plot(pitch, color="tomato", linewidth=0.7)
        ax1.set_xlim(0, mel.shape[1])
        ax1.set_ylim(0, pitch_max)
        ax1.set_ylabel("F0", color="tomato")
        ax1.tick_params(labelsize="x-small", colors="tomato",
                        bottom=False, labelbottom=False)

        ax2 = add_axis(fig, axes[i][0])
        ax2.plot(energy, color="darkviolet", linewidth=0.7)
        ax2.set_xlim(0, mel.shape[1])
        ax2.set_ylim(energy_min, energy_max)
        ax2.set_ylabel("Energy", color="darkviolet")
        ax2.yaxis.set_label_position("right")
        ax2.tick_params(labelsize="x-small", colors="darkviolet",
                        bottom=False, labelbottom=False,
                        left=False, labelleft=False,
                        right=True, labelright=True)
    return fig
