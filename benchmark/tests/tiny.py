"""Test-only cells at tiny widths, found through the harness by name like
any cell: their configuration and traffic files live under
``benchmark/tests/data``, the metric readers they report are the
benchmark's own plus ``data/metrics``."""

import os

from benchmark.harness.cell import BENCH_DIR, Cell

DATA = os.path.join(BENCH_DIR, "tests", "data")

BENCH = {
    "configs": [
        {"name": "tiny_serve", "file": "benchmark/tests/data/configs/"
         "tiny_serve.json"},
        {"name": "tiny_train", "file": "benchmark/tests/data/configs/"
         "tiny_train.json"}],
    "workloads": [
        {"name": "tiny.closed", "config": "tiny_serve",
         "traffic": "tiny_closed", "chips": 1},
        {"name": "tiny.train", "config": "tiny_train",
         "traffic": "tiny_train", "chips": 1}],
    "end_to_end": [
        {"name": "serve_utt_per_s", "unit": "utt/s",
         "workloads": ["tiny.closed"]},
        {"name": "train_frames_per_s", "unit": "frames/s",
         "workloads": ["tiny.train"]},
        {"name": "setup_s", "unit": "s"}],
    "per_layer": [
        {"name": "server.mean_batch.closed", "unit": "req/batch",
         "moves": "serve_utt_per_s", "workloads": ["tiny.closed"]},
        {"name": "dispatch.ms.closed", "unit": "ms",
         "moves": "serve_utt_per_s", "workloads": ["tiny.closed"]},
        {"name": "test.dispatches", "unit": "dispatches",
         "moves": "serve_utt_per_s", "workloads": ["tiny.closed"]},
        {"name": "train.capture_s", "unit": "s", "moves": "setup_s",
         "workloads": ["tiny.train"]},
        {"name": "train.mfu", "unit": "%", "moves": "train_frames_per_s",
         "workloads": ["tiny.train"]}],
}


def cell(name):
    return Cell(BENCH, name, dirs=(DATA, BENCH_DIR))
