"""Structured JSONL event logging and an optional TensorBoard scalar mirror:
the counterpart of the JAX package's `golfaction_tpu/utils/logging.py`, with
the same line format.  `_to_plain` also takes tensors on any device."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Optional

import numpy as np
import torch


class JsonlLogger:
    """Append-only JSONL event log; also mirrors to stderr when verbose."""

    def __init__(self, path: Optional[str] = None, verbose: bool = False):
        self.path = path
        self.verbose = verbose
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")
        else:
            self._fh = None

    def log(self, event: str, **fields: Any) -> None:
        rec = {"ts": time.time(), "event": event, **_to_plain(fields)}
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.verbose:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


class TensorBoardScalars:
    """Optional TensorBoard scalar writer.

    A no-op when `logdir` is None or `torch.utils.tensorboard` cannot be
    imported (tensorboard not installed); when a logdir was asked for and
    tensorboard is there, construction errors (an unwritable logdir, ...)
    surface.  `log` writes the int and float fields and skips the rest."""

    def __init__(self, logdir: Optional[str]):
        self._w = None
        if logdir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:   # tensorboard not installed: stay a no-op
                return
            self._w = SummaryWriter(logdir)

    @property
    def active(self) -> bool:
        return self._w is not None

    def log(self, step: int, **fields: Any) -> None:
        if self._w is None:
            return
        for k, v in _to_plain(fields).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self._w.add_scalar(k, v, step)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None


def _to_plain(obj):
    """numpy and torch scalars and arrays (on any device) -> JSON-safe
    python values."""
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj
