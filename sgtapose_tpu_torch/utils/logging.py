"""Training observability: metrics.jsonl, TensorBoard when it imports, and
image logs.

Counterpart of `sgtapose_tpu/utils/logging.py:MetricsLogger`: one JSON
record per `log` call ({"ts", "step", "prefix", scalars...}) in
output_dir/metrics.jsonl, which a fresh run truncates and a resumed run
appends to; the same scalars to TensorBoard when
`torch.utils.tensorboard` imports; `log_image` writes viz/{name}_{step}.png.
With output_dir None (ranks other than 0) the logger writes nothing.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, output_dir: Optional[str], use_tensorboard: bool = True, resume: bool = False):
        self.path = None
        self._f = None
        self._tb = None
        if output_dir is None:
            return
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        # a fresh run truncates: appending would interleave two runs' records
        # at overlapping steps with no delimiter
        self._f = open(self.path, "a" if resume else "w")
        if use_tensorboard:
            # optional: a missing or broken TensorBoard install costs the
            # TensorBoard copy of the scalars, never the run
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(output_dir, "tb"))
            except Exception as e:  # noqa: BLE001
                print(f"MetricsLogger: TensorBoard off ({type(e).__name__}: {e})")

    def log(self, step: int, scalars: Dict[str, float], prefix: str = "train") -> None:
        if self._f is None:
            return
        rec = {"ts": time.time(), "step": int(step), "prefix": prefix}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{prefix}/{k}", float(v), int(step))

    def log_image(self, step: int, name: str, pil_image, prefix: str = "train") -> None:
        """A PNG under viz/ (always), and the image in TensorBoard."""
        import numpy as np

        if self.path is None:
            return
        viz_dir = os.path.join(os.path.dirname(self.path), "viz")
        os.makedirs(viz_dir, exist_ok=True)
        pil_image.save(os.path.join(viz_dir, f"{name}_{int(step):07d}.png"))
        if self._tb is not None:
            self._tb.add_image(f"{prefix}/{name}", np.asarray(pil_image), int(step), dataformats="HWC")

    def close(self) -> None:
        if self._f is None:
            return
        self._f.close()
        self._f = None
        if self._tb is not None:
            self._tb.close()
