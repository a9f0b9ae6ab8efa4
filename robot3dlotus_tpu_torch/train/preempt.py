"""Preemption-aware training: checkpoint + requeue on SIGUSR1/SIGTERM (the
port's copy of robot3dlotus_tpu/train/preempt.py).

Reference parity: train/utils/slurm_requeue.py:11-28 installs a SIGUSR1
handler that calls `scontrol requeue $SLURM_JOB_ID` from rank 0. Here the
signal only sets a flag; the training loop observes it at a step boundary,
saves `train_state_latest` (auto-resume picks it up on the next launch),
requeues, and exits cleanly — signal-safe by construction, and it works
the same under any scheduler that delivers a warning signal (SLURM
--signal=USR1@120, Borg/GKE SIGTERM grace windows, spot-VM shutdown
scripts).
"""
from __future__ import annotations

import logging
import os
import signal
import subprocess

LOGGER = logging.getLogger("robot3dlotus_tpu_torch.preempt")


class PreemptionFlag:
    """Set asynchronously by a signal; polled by the training loop."""

    def __init__(self):
        self.triggered = False
        self.signum = None
        self.previous = {}   # signal -> the handler installed before

    def __bool__(self):
        return self.triggered

    def restore(self):
        """Puts back the handlers that were installed before."""
        for sig, prev in self.previous.items():
            signal.signal(sig, prev)
        self.previous = {}


def install_preemption_handler(signals=(signal.SIGUSR1, signal.SIGTERM)):
    """Installs flag-setting handlers; returns the flag. Chained safely:
    previous handlers are preserved and called after the flag is set, and
    flag.restore() reinstalls them."""
    flag = PreemptionFlag()

    def make_handler(prev):
        def handler(signum, frame):
            flag.triggered = True
            flag.signum = signum
            if callable(prev):
                prev(signum, frame)
        return handler

    for sig in signals:
        try:
            prev = signal.getsignal(sig)
            signal.signal(sig, make_handler(prev))
            flag.previous[sig] = prev
        except (ValueError, OSError):  # non-main thread / unsupported
            LOGGER.warning("could not install handler for %s", sig)
    return flag


def requeue_self():
    """Requeue the surrounding SLURM job, if any. Returns True if a
    requeue was issued (reference slurm_requeue.py:19-25)."""
    job_id = os.environ.get("SLURM_JOB_ID")
    if not job_id:
        return False
    try:
        subprocess.check_call(["scontrol", "requeue", job_id])
        LOGGER.info("requeued SLURM job %s", job_id)
        return True
    except Exception:
        LOGGER.exception("scontrol requeue %s failed", job_id)
        return False
