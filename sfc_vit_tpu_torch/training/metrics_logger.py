"""Structured metrics logging: JSONL + CSV + stdout.

Counterpart of ``sfc_vit_tpu/training/metrics_logger.py`` (which imports
no jax at module level; only its default ``primary`` asks jax for the
process index, here ``torch.distributed`` for the rank).  Per-epoch
records are machine-readable and carry throughput (images/sec).
TensorBoard event files are not ported yet: ``tensorboard=True`` raises
(ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

import csv
import json
import pathlib
import sys
import time
from typing import Dict, Optional

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(
        self,
        directory: Optional[str | pathlib.Path] = None,
        stdout: bool = True,
        tensorboard: bool = False,
        primary: Optional[bool] = None,
    ) -> None:
        """``primary``: whether this process owns the sinks.  Default
        (None) = rank 0 of ``torch.distributed`` when it is initialised,
        else True: every process appending identical rows to one shared
        metrics.jsonl/csv would corrupt the run history."""
        if tensorboard:
            raise NotImplementedError(
                "MetricsLogger: TensorBoard is not ported to PyTorch yet: "
                "ROADMAP.md queue 1 item 8 (entry points)")
        if primary is None:
            import torch.distributed as dist

            primary = (not dist.is_available() or not dist.is_initialized()
                       or dist.get_rank() == 0)
        self.stdout = stdout and primary
        self._jsonl = None
        self._csv_path = None
        self._csv_fields = None
        if directory is not None and primary:
            d = pathlib.Path(directory)
            d.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(d / "metrics.jsonl", "a", buffering=1)
            self._csv_path = d / "metrics.csv"
        self._t0 = time.time()

    def log(self, record: Dict) -> None:
        record = dict(record)
        record.setdefault("wall_time", round(time.time() - self._t0, 3))
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(record) + "\n")
        if self._csv_path is not None:
            new = not self._csv_path.exists()
            if self._csv_fields is None:
                if new:
                    self._csv_fields = list(record)
                else:
                    # resumed run: append under the EXISTING header --
                    # freezing columns from this process's first record
                    # would misalign rows when the record shapes differ
                    # (e.g. the fully-resumed eval-only record has no
                    # train_* keys)
                    with open(self._csv_path, newline="") as f:
                        header = next(csv.reader(f), None)
                    self._csv_fields = header or list(record)
            with open(self._csv_path, "a", newline="") as f:
                writer = csv.DictWriter(
                    f, fieldnames=self._csv_fields,
                    extrasaction="ignore", restval="",
                )
                if new:
                    writer.writeheader()
                writer.writerow(record)
        if self.stdout:
            parts = [
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in record.items()
            ]
            print(" ".join(parts), file=sys.stderr)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
