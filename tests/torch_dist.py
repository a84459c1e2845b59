"""Run a function on N CPU ranks of the port (one spawned process a rank,
joined over gloo through a ``file://`` store), for the multi-rank tests.

The function lives in a module the ranks import without JAX
(tests/torch_parallel_workers.py); it is called as fn(rank, n, *args) and
rank 0's return value comes back pickled.  A rank that raises fails the
call with its traceback; ranks still running after ``timeout`` seconds are
killed and fail it too, so a hung collective fails its test instead of
the suite's clock."""

from __future__ import annotations

import glob
import os
import pickle
import tempfile
import time
import traceback


def _entry(rank, n, fn, args, tmp):
    import torch

    torch.set_num_threads(1)
    from pixelnerf_yolo_torch import parallel

    try:
        parallel.init_process_group(rank, n, "cpu", list(range(n)),
                                    os.path.join(tmp, "store"))
        out = fn(rank, n, *args)
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        parallel.destroy_process_group()


def run_ranks(n: int, fn, *args, timeout: float = 150.0):
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_entry, args=(r, n, fn, args, tmp))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = "".join(open(f).read() for f in
                         sorted(glob.glob(os.path.join(tmp, "err*.txt"))))
        if hung:
            raise AssertionError(
                f"ranks {hung} still ran after {timeout} s\n{errors}")
        codes = [p.exitcode for p in procs]
        if errors or any(codes):
            raise AssertionError(f"rank exit codes {codes}\n{errors}")
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
