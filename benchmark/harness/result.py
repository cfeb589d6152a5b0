"""The run's last line: the result object, the device it ran on, and the
numbers the correctness check compared, each beside its limit."""

import json
import subprocess
import sys

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "fastspeech2_tpu")


def forbidden_modules(names=None):
    """Loaded modules whose top-level name (the part before the first dot)
    is one of FORBIDDEN, compared whole: ``fastspeech2_tpu_torch`` is not
    ``fastspeech2_tpu``."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def power_limit():
    """The card's name and power limit as nvidia-smi reports them, or
    None where nvidia-smi is not there."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    line = out.stdout.strip().splitlines()
    return line[0].strip() if out.returncode == 0 and line else None


def device_info(device, count=1):
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    device))}
        limit = power_limit()
        if limit is not None:
            info["nvidia_smi"] = limit
        return info
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0}


def emit(correct, attempted, failed, metrics, device, checks,
         breakdown=None):
    """Print the result line (last line of stdout) and the compared numbers
    (last lines of stderr)."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
