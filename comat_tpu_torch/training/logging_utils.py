"""Metrics and logging for the trainer.

The port's copy of the host side of comat_tpu/training/logging_utils.py:
python logging to the console and `<output_dir>/log.txt`, a JSONL scalar
stream `<output_dir>/metrics.jsonl` keyed as the reference logs
(train_loss, step_loss, lr, the reward breakdown, G/D loss, token/pixel
loss, reward_norm; training_script.py:667-706) and validation images as
PNG files under `<output_dir>/validation_images/`. The PNGs are written
with the standard library (`write_png`); a failed write raises. With a
logging dir (the trainer's --report_to tensorboard, its default) every
scalar and the validation images also go to a TensorBoard log under
`<output_dir>/<logging_dir>`, through
`torch.utils.tensorboard`, as JAX writes them; where that writer cannot be
made (no tensorboard package), one warning names the reason and
metrics.jsonl is kept. Under a process group every log line carries its
rank (JAX's `[proc N]`), and rank 0 alone writes log.txt, metrics.jsonl,
the TensorBoard log and the images.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

import numpy as np

from comat_tpu_torch.tools.generate import write_png

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def set_logger(output_dir: Optional[str] = None, rank: Optional[int] = None
               ) -> logging.Logger:
    """The port's logger; with `rank` (under a process group) each line
    carries it, and only rank 0 writes `<output_dir>/log.txt`."""
    fmt = _FORMAT if rank is None else _FORMAT.replace(
        "%(levelname)s", f"[rank {rank}] %(levelname)s")
    logging.basicConfig(level=logging.INFO, format=fmt)
    logger = logging.getLogger("comat_tpu_torch")
    if output_dir and not rank:
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.abspath(os.path.join(output_dir, "log.txt"))
        if not any(getattr(h, "baseFilename", None) == path for h in logger.handlers):
            fh = logging.FileHandler(path)
            fh.setFormatter(logging.Formatter(fmt))
            logger.addHandler(fh)
    return logger


class MetricsWriter:
    """metrics.jsonl (appended, one record per step) and PNG images; with
    `logging_dir`, a TensorBoard log of the same scalars (tags the metric
    names) and images. With `main` False (a rank other than 0) it writes
    nothing."""

    def __init__(self, output_dir: str, logging_dir: Optional[str] = None,
                 main: bool = True):
        self.main = main
        self.f = self.tb = None
        if not main:
            return
        os.makedirs(output_dir, exist_ok=True)
        self.f = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        self.img_dir = os.path.join(output_dir, "validation_images")
        self.tb = None
        if logging_dir is not None:
            tb_dir = os.path.join(output_dir, logging_dir)
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(tb_dir)
            except Exception as e:      # e.g. no tensorboard package
                logging.getLogger("comat_tpu_torch").warning(
                    "no TensorBoard log at %s (%s: %s); metrics go to metrics.jsonl only",
                    tb_dir, type(e).__name__, e)

    def log(self, metrics: Dict[str, float], step: int) -> None:
        if not self.main:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(k, float(v), step)

    def log_images(self, tag: str, images, step: int) -> None:
        """NHWC float [0, 1] images -> `<tag>_<step>_<i>.png` (the
        validation grids of training_script.py:485-489), and to the
        TensorBoard log."""
        if not self.main:
            return
        os.makedirs(self.img_dir, exist_ok=True)
        arr = np.clip(np.asarray(images, np.float32), 0, 1)
        if self.tb is not None:
            self.tb.add_images(tag, arr.transpose(0, 3, 1, 2), step)
        for i, im in enumerate((arr * 255).astype(np.uint8)):
            write_png(os.path.join(self.img_dir, f"{tag}_{step}_{i}.png"), im)

    def close(self) -> None:
        if self.f is not None:
            self.f.close()
        if self.tb is not None:
            self.tb.close()
