"""The benchmark of fastspeech2_tpu_torch on an NVIDIA GPU:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell is an entry of BENCHMARK.json's
``workloads``; its configuration and traffic files, and the reader of each
per-layer metric, are found by name (benchmark/harness/cell.py).  A run
loads and warms up, measures for ``--seconds``, checks what the timed path
produced against the plain reference, and prints one JSON line last on
stdout.  With ``--trace 1`` the metrics are the cell's per-layer ones,
read from a torch.profiler window and the harness's counters; otherwise
its end-to-end ones.

It exits non-zero with no result where CUDA or the cell's cards are
missing, and where a module of jax, jaxlib, flax or fastspeech2_tpu is
loaded once the window has closed.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache of a run inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(
    ROOT, ".bench_cache", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(
    ROOT, ".bench_cache", "torch_extensions"))
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark.harness.cell import Cell
    from benchmark.harness import result

    cell = Cell.load(args.workload, ROOT)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    driver = importlib.import_module(
        f"benchmark.harness.{cell.traffic['driver']}")
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda:0"), T_START)
    if out.get("notes"):
        print(f"benchmark: {json.dumps(out['notes'])}", file=sys.stderr)
    bad = result.forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    result.emit(out["correct"], out["attempted"], out["failed"],
                out["metrics"], out["device"], out["checks"],
                out["breakdown"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
