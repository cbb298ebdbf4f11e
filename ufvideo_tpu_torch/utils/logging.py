"""Logging + profiling utilities (mirrors ``ufvideo_tpu/utils/logging.py``).

- ``build_logger``: stdout/stderr capture into a daily-rotating file, with
  the reference's interface.
- ``profile_trace``: a ``torch.profiler`` trace scope (CPU and CUDA
  activities), written as a Chrome trace into ``log_dir`` with the program's
  spans (``utils.tracing``) of the scope beside kineto's events.
- ``rank0_print``: print on rank 0 of a ``torch.distributed`` group, or
  always when there is none.
"""

from __future__ import annotations

import contextlib
import json
import logging
import logging.handlers
import os
import sys
import time
from typing import Optional

_handler: Optional[logging.Handler] = None


class StreamToLogger:
    """File-like that forwards writes to a logger (utils.py:60-90)."""

    def __init__(self, logger: logging.Logger, level: int = logging.INFO):
        self.logger = logger
        self.level = level
        self._buf = ""

    def __getattr__(self, attr):
        return getattr(sys.__stdout__, attr)

    def write(self, buf: str) -> None:
        self._buf += buf
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            if line:
                self.logger.log(self.level, line)

    def flush(self) -> None:
        if self._buf:
            self.logger.log(self.level, self._buf)
            self._buf = ""


def build_logger(
    logger_name: str, logger_filename: str, log_dir: str = "."
) -> logging.Logger:
    global _handler
    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    logging.basicConfig(level=logging.INFO, format=formatter._fmt)

    if _handler is None:
        os.makedirs(log_dir, exist_ok=True)
        _handler = logging.handlers.TimedRotatingFileHandler(
            os.path.join(log_dir, logger_filename),
            when="D", utc=True, encoding="utf-8",
        )
        _handler.setFormatter(formatter)
        for name, item in logging.root.manager.loggerDict.items():
            if isinstance(item, logging.Logger):
                item.addHandler(_handler)

    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)
    logger.addHandler(_handler)
    return logger


def rank0_print(*args) -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
        return
    print(*args)


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """``torch.profiler`` scope over CPU and (when present) CUDA activity;
    on exit the trace goes to ``log_dir/trace.json`` (chrome://tracing,
    Perfetto), with the spans the program recorded in the scope on the same
    clock, one row a thread under the process ``ufvideo spans``."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import tracing

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.time_ns()
    with profile(activities=acts) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"] += tracing.chrome_events(tracing.RECORDER.spans(t0, time.time_ns()),
                                                  trace.get("baseTimeNanoseconds", 0))
    with open(path, "w") as f:
        json.dump(trace, f)
