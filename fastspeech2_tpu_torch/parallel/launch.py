"""Run a function on N ranks of a fresh ``torch.distributed`` world, each
in its own process, from one parent: what the multi-process tests and the
card's two-ranks-on-one-card check use (a user's run goes through
``torchrun`` instead).

The ranks start with the ``spawn`` method (the parent may hold threads,
and a forked JAX or CUDA runtime is not safe), meet through a
``FileStore`` in a directory the caller owns (no fixed TCP port, so
several such worlds can run at once), run on one CPU thread each, and
hand back what ``fn`` returns (picklable: numpy arrays, not tensors).
The arguments go through a pickle file beside the store: a process
started by ``spawn`` takes its arguments through a pipe, and a parent
writing more than the pipe holds waits until that child has imported its
modules, so the ranks would start one after another.
The parent waits for each at most ``timeout`` seconds in all and then
kills the rest and raises, so a hung rank cannot hang its caller.
"""

import multiprocessing
import os
import pickle
import queue
import time
import traceback


def _rank_main(fn, rank, world, backend, store, results):
    import torch

    from fastspeech2_tpu_torch.parallel.mesh import init_distributed

    try:
        with open(store + ".args", "rb") as f:
            args = pickle.load(f)
        torch.set_num_threads(1)
        init_distributed(backend, init_method=f"file://{store}",
                         world_size=world, rank=rank)
        out = fn(rank, world, *args)
        results.put((rank, True, out))
    except BaseException:   # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world, args=(), store_dir=".", backend="gloo",
              timeout=120.0):
    """fn(rank, world, *args) on ``world`` spawned ranks -> the list of
    their results in rank order.  ``fn`` must be importable by name."""
    ctx = multiprocessing.get_context("spawn")
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(os.path.abspath(store_dir),
                         f"store_{os.getpid()}_{time.monotonic_ns()}")
    with open(store + ".args", "wb") as f:
        pickle.dump(args, f)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, store, results),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got, deadline, failed = {}, time.monotonic() + timeout, True
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world)) - set(got))} of "
                    f"{world} gave no result within {timeout:.0f} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and not p.is_alive()
                        and p.exitcode not in (0, None)]
                if dead:
                    raise RuntimeError(f"ranks {dead} died (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        failed = False
    finally:
        # after a failure the other ranks may wait in a collective forever
        for p in procs:
            p.join(timeout=1.0 if failed
                   else max(deadline - time.monotonic(), 5.0))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
    return [got[r] for r in range(world)]
