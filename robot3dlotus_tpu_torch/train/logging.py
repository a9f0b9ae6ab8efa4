"""Logging: stdlib logger with file handler + step-metric jsonl writer
(+ optional tensorboardX), mirroring reference train/utils/logger.py (the
port's copy of robot3dlotus_tpu/train/logging.py). The logger is the
port's package logger, so every module logger under it (the training
loop's robot3dlotus_tpu_torch.train, the preemption handler's) reaches its
handlers."""
from __future__ import annotations

import json
import logging
import os
import time


def build_logger(output_dir=None, name="robot3dlotus_tpu_torch"):
    """Idempotent per output_dir: a second run in the same process (several
    trainings sequentially, notebooks, test suites) re-points the file
    handler at ITS run directory instead of silently appending to the
    first run's log.txt."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(levelname)s: %(message)s",
                            datefmt="%m/%d %H:%M:%S")
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if output_dir:
        target = os.path.abspath(
            os.path.join(output_dir, "logs", "log.txt"))
        file_handlers = [h for h in logger.handlers
                         if isinstance(h, logging.FileHandler)]
        if not any(os.path.abspath(h.baseFilename) == target
                   for h in file_handlers):
            for h in file_handlers:  # the new run owns the file log
                logger.removeHandler(h)
                h.close()
            os.makedirs(os.path.join(output_dir, "logs"), exist_ok=True)
            fh = logging.FileHandler(target)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class MetricWriter:
    """jsonl step metrics; also mirrors to tensorboardX when available."""

    def __init__(self, output_dir):
        os.makedirs(os.path.join(output_dir, "logs"), exist_ok=True)
        self.path = os.path.join(output_dir, "logs", "metrics.jsonl")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
            self._tb = SummaryWriter(os.path.join(output_dir, "logs", "tb"))
        except Exception:
            pass

    def write(self, step, metrics: dict):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), int(step))
