"""Run-directory archival (``ampnet_tpu/train/rundir.py``): a timestamped
directory with gradients/activations subdirectories, a _details.txt
logfile, and a snapshot of the experiment script that started the run."""
from __future__ import annotations

import datetime
import os
import shutil
import sys
from typing import Optional


def create_run_dir(
    base: str = "runs",
    details: str = "",
    snapshot_source: Optional[str] = None,
) -> str:
    stamp = datetime.datetime.now().strftime("%Y-%m-%d-%H_%M_%S")
    run_dir = os.path.join(base, stamp)
    os.makedirs(os.path.join(run_dir, "gradients"), exist_ok=True)
    os.makedirs(os.path.join(run_dir, "activations"), exist_ok=True)
    with open(os.path.join(run_dir, "_details.txt"), "w") as f:
        f.write(details + "\n")
    src = snapshot_source or (sys.argv[0] if sys.argv and os.path.exists(sys.argv[0]) else None)
    if src:
        try:
            shutil.copy(src, os.path.join(run_dir, os.path.basename(src)))
        except OSError:
            pass   # the snapshot is a convenience; the run goes on without it
    return run_dir


class Logfile:
    """Console + optional logfile sink with flush."""

    def __init__(self, path: Optional[str] = None):
        self.f = open(path, "a") if path else None

    def log(self, msg: str):
        print(msg)
        if self.f:
            self.f.write(msg + "\n")
            self.f.flush()

    def close(self):
        if self.f:
            self.f.close()
