"""The traced window: torch.profiler with CPU and CUDA activity, over one
span or several (``start`` and ``stop`` again), reduced to the device's
busy seconds (the union of its kernel, copy and set intervals in each
span), the spans' total seconds, each kernel name's count and seconds, and
the longest idle gaps with the host operation that overlaps each most."""

import bisect
import time

import torch


class Window:
    def __init__(self, device):
        self.device = device
        self.profiles = []
        self.spans = []
        self.t0 = self.t1 = None
        self.stop_s = 0.0

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        self.profiles.append(prof)
        if self.device.type == "cuda":
            # a first kernel in the span (the profiler has been seen to
            # drop a span's first device events)
            torch.zeros(1, device=self.device).add_(1)
        t = time.monotonic()
        self.spans.append([t, None])
        if self.t0 is None:
            self.t0 = t

    @property
    def open(self):
        return bool(self.spans) and self.spans[-1][1] is None

    def stop(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = self.spans[-1][1] = time.monotonic()
        self.profiles[-1].stop()
        self.stop_s += time.monotonic() - self.t1

    def reduce(self, n_gaps=10, n_ops=10):
        cuda = torch.autograd.DeviceType.CUDA
        kernels, gaps, busy = {}, [], 0.0
        for prof in self.profiles:
            dev, host = [], []
            for e in prof.profiler.kineto_results.events():
                start = e.start_ns()
                (dev if e.device_type() == cuda else host).append(
                    (start, start + e.duration_ns(), e.name()))
            dev.sort()
            for s, t, name in dev:
                n, sec = kernels.get(name, (0, 0.0))
                kernels[name] = (n + 1, sec + (t - s) * 1e-9)
            union, span_gaps = [], []
            for s, t, _ in dev:
                if union and s <= union[-1][1]:
                    union[-1][1] = max(union[-1][1], t)
                else:
                    if union:
                        span_gaps.append((s - union[-1][1], union[-1][1], s))
                    union.append([s, t])
            busy += sum(t - s for s, t in union) * 1e-9
            span_gaps.sort(reverse=True)
            host.sort()
            starts = [h[0] for h in host]
            longest = max((t - s for s, t, _ in host), default=0)
            for length, s, t in span_gaps[:n_gaps]:
                best, best_len = "host: no recorded operation", 0
                lo = bisect.bisect_left(starts, s - longest)
                for hs, ht, name in host[lo:bisect.bisect_right(starts, t)]:
                    ov = min(ht, t) - max(hs, s)
                    if ov > best_len:
                        best, best_len = "host: " + name, ov
                gaps.append((length, best))
        gaps.sort(reverse=True)
        ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:n_ops]
        return {"busy_s": busy,
                "window_s": sum(t - s for s, t in self.spans),
                "spans": len(self.spans), "t0": self.t0, "t1": self.t1,
                "kernels": kernels,
                "breakdown": {"device_ops": [[n, v[1]] for n, v in ops],
                              "idle_gaps": [[name, length * 1e-9] for
                                            length, name in gaps[:n_gaps]]}}


def kernel_seconds(kernels, *needles, exclude=()):
    """Seconds and count of the kernels whose lower-case name holds every
    needle and no excluded word."""
    sec, n = 0.0, 0
    for name, (count, s) in kernels.items():
        low = name.lower()
        if all(k in low for k in needles) and not any(x in low
                                                      for x in exclude):
            sec += s
            n += count
    return sec, n
