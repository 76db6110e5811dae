"""Structured metric logging: stdout + CSV.

Port of cl_ica_tpu/train/metrics.py, which is jax-free but cannot be
imported from here: cl_ica_tpu/train/__init__.py pulls in jax. Its
TensorBoard option is not ported: its only user, main_kitti's
--use-writer, hands the writer the run's args alone, and ``log_args``
writes them as args.json.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(
        self,
        log_dir: Optional[str] = None,
        print_to_stdout: bool = True,
    ):
        self.log_dir = log_dir
        self.print_to_stdout = print_to_stdout
        self._csv_file = None
        self._csv_writer = None
        self._csv_fields = None
        self._t0 = time.time()
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._csv_path = os.path.join(log_dir, "log.csv")

    def log_args(self, args_dict: Dict):
        """Dump run arguments as json."""
        if self.log_dir:
            with open(os.path.join(self.log_dir, "args.json"), "w") as fh:
                json.dump(args_dict, fh, indent=2, default=str)

    def log(self, step: int, metrics: Dict[str, float]):
        metrics = {k: float(v) for k, v in metrics.items()}
        if self.print_to_stdout:
            parts = [f"Step: {step}"] + [f"{k}: {v:.4f}" for k, v in metrics.items()]
            print(" \t ".join(parts), flush=True)
        if self.log_dir:
            if self._csv_writer is None:
                self._csv_fields = ["step", "wall_time"] + sorted(metrics)
                self._csv_file = open(self._csv_path, "a", newline="")
                self._csv_writer = csv.DictWriter(
                    self._csv_file, fieldnames=self._csv_fields, extrasaction="ignore"
                )
                if self._csv_file.tell() == 0:
                    self._csv_writer.writeheader()
            row = {"step": step, "wall_time": time.time() - self._t0, **metrics}
            self._csv_writer.writerow(row)
            self._csv_file.flush()

    def close(self):
        if self._csv_file:
            self._csv_file.close()
