"""Metrics logging (port of the JAX ``utils/metrics.py``, without wandb):
one JSONL record per epoch and one per checkpoint written, and a snapshot
of the run's config beside them that ``Config.from_json_file`` reads back.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from .. import __version__


class MetricsLogger:
    """Appends JSON lines to ``<log_dir>/<run_name>.metrics.jsonl``."""

    def __init__(self, log_dir: str = "results",
                 run_name: Optional[str] = None):
        os.makedirs(log_dir, exist_ok=True)
        self.run_name = run_name or f"run_{int(time.time())}"
        self.path = os.path.join(log_dir, f"{self.run_name}.metrics.jsonl")
        self._f = open(self.path, "a")

    def log(self, step: int, **metrics):
        rec = {"step": step, "time": time.time(), **metrics}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def log_artifact(self, path: str):
        """A pointer to a checkpoint written (the reference uploads it)."""
        self._f.write(json.dumps({"artifact": path,
                                  "time": time.time()}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def snapshot_run_config(cfg, logger: MetricsLogger) -> str:
    """Write the run's config beside the metrics as
    ``<run_name>.config.json`` (with the package version, which
    ``Config.from_dict`` ignores); returns its path."""
    path = logger.path[:-len(".metrics.jsonl")] + ".config.json"
    doc = json.loads(cfg.to_json())
    doc["framework_version"] = __version__
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    logger.log_artifact(path)
    return path
