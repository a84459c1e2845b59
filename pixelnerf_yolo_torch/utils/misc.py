"""Small host utilities: timestamped printing, unwrapping a render
binding, parameter counting and the stall watchdog.

Counterpart of pixelnerf_yolo_tpu/utils/misc.py; ``count_parameters``
counts a torch ``state_dict``'s (or a module's) tensors.
"""

from __future__ import annotations

import datetime


def print_with_time(*args, **kwargs):
    timestamp = datetime.datetime.now().strftime("%H:%M:%S")
    message = " ".join(map(str, args))
    print(f"[{timestamp}] {message}", **kwargs)


def get_module(net):
    """A parallel render binding's model (``RenderParallel.model``);
    anything else as it is."""
    return getattr(net, "model", net)


def count_parameters(params) -> int:
    """Total number of scalars in a ``state_dict`` (a mapping of tensors)
    or in a module's parameters."""
    tensors = params.values() if hasattr(params, "values") else \
        params.parameters()
    return int(sum(t.numel() for t in tensors))


class StallWatchdog:
    """Abort the process when no device result has materialized for
    ``timeout_s`` seconds.

    A device or a remote link to it can die mid-run, leaving the client
    blocked FOREVER inside its next device call — no exception, no
    timeout.  An unattended training job
    then hangs silently instead of failing.  The trainer and eval loop
    call :meth:`beat` on every host-side progress point (each dispatch
    return, each materialized device scalar, each eval/vis/metric/save
    phase); the loops are sequential, so a lost device blocks INSIDE one
    call and every beat stops.  After ``timeout_s`` without a beat the
    watchdog prints a diagnostic and hard-exits the process (``os._exit``
    — a normal exception cannot interrupt a thread blocked inside the
    runtime) so a supervisor can restart or alert.

    Opt-in: enabled only when ``PNY_STALL_ABORT_S`` is set.  The one
    indistinguishable case is a healthy-but-long first step (the kernels'
    nvcc build runs inside it, beatless) — pick a window longer than
    that.

    The abort is ``os._exit``: it skips the trainer's save paths and any
    atexit/finally cleanup (a thread blocked inside the runtime cannot
    run them anyway), so up to one full ``save_interval`` of progress is
    discarded.  When enabling PNY_STALL_ABORT_S on an unattended run,
    pair it with a ``train.save_interval`` small enough to bound the
    lost work (the checkpoint writes are atomic, so a mid-save abort
    never corrupts the previous checkpoint).
    """

    def __init__(self, timeout_s: float, exit_code: int = 3,
                 poll_s: float = 5.0, _exit=None, _now=None):
        import os as _os
        import time as _time

        self.timeout_s = float(timeout_s)
        self.exit_code = exit_code
        self.poll_s = poll_s
        self._exit = _exit if _exit is not None else _os._exit
        self._now = _now if _now is not None else _time.monotonic
        self._last = self._now()
        self._stop = False
        self._thread = None

    def beat(self) -> None:
        self._last = self._now()

    def start(self) -> "StallWatchdog":
        import threading
        import time as _time

        def _watch():
            while not self._stop:
                _time.sleep(self.poll_s)
                if self._stop:
                    return
                stalled = self._now() - self._last
                if stalled > self.timeout_s:
                    print_with_time(
                        f"STALL: no device result for {stalled:.0f}s "
                        f"(> PNY_STALL_ABORT_S={self.timeout_s:.0f}); the "
                        "device is likely lost — aborting"
                    )
                    self._exit(self.exit_code)
                    return  # only reached with an injected _exit (tests)

        self._thread = threading.Thread(target=_watch, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop = True


def stall_watchdog_from_env():
    """Start a StallWatchdog when ``PNY_STALL_ABORT_S`` is set (else None)
    — the shared opt-in contract for every long-running device loop
    (trainer, eval.py, gen_video.py)."""
    import os as _os

    stall_s = float(_os.environ.get("PNY_STALL_ABORT_S", "0") or 0.0)
    if stall_s <= 0:
        return None
    return StallWatchdog(stall_s).start()
