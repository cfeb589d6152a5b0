"""A cell of ``BENCHMARK.json``, found by name: its workload entry, its
configuration file, its traffic file (``benchmark/traffic/<traffic>.json``)
and the per-layer metrics it reports, each metric's reader being
``benchmark/metrics/<metric name>.py``.  ``dirs``: where traffic and
metric files are looked for, in order (a test adds its own)."""

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Cell:
    def __init__(self, bench, workload, root=ROOT, dirs=(BENCH_DIR,)):
        self.root = root
        self.dirs = tuple(dirs)
        self.bench = bench
        entries = {w["name"]: w for w in bench["workloads"]}
        if workload not in entries:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = entries[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        with open(os.path.join(root, self.config_entry["file"])) as f:
            self.config = json.load(f)
        with open(self.traffic_path()) as f:
            self.traffic = json.load(f)

    @classmethod
    def load(cls, workload, root=ROOT):
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            return cls(json.load(f), workload, root)

    def traffic_path(self):
        return _find(self.dirs, "traffic", self.workload["traffic"] + ".json")

    def reader(self, name):
        """The ``read(ctx)`` function of per-layer metric ``name``."""
        path = _find(self.dirs, "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def _reports(self, metric):
        listed = metric.get("workloads")
        if listed is not None:
            return self.name in listed
        moves = metric["moves"]
        return any(m["name"] == moves for m in self.end_to_end())

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self):
        return [m for m in self.bench["per_layer"] if self._reports(m)]

    def metrics(self, trace):
        return self.per_layer() if trace else self.end_to_end()


def _find(dirs, kind, filename):
    """The first of ``dirs`` that holds ``kind/filename``."""
    for d in dirs:
        path = os.path.join(d, kind, filename)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no {kind}/{filename} under {list(dirs)}")
