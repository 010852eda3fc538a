"""Structured metric logging: stdout + JSONL file, optional wandb.

The port's own copy of `avtubes/utils/logging.py`: every record goes to a
JSONL file under summaries_dir (greppable, diffable) and to stdout; wandb
attaches only if available and requested — observability must not be a hard
dependency.  A zero-dimensional tensor is logged as its float, which waits
for the device.  `log_image` writes an overlay image as a JPEG under
`<summaries_dir>/images/` (PIL, imported when an image is logged) and to
wandb where it is attached.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Any


class MetricLogger:
    def __init__(self, summaries_dir: str | Path | None = None, run_name: str = "run",
                 use_wandb: bool = False, config: dict[str, Any] | None = None,
                 enabled: bool = True):
        # multi-process runs pass enabled=is_primary(): one process owns the
        # JSONL/wandb/stdout stream (N processes appending one file interleave)
        self.enabled = enabled
        self.path = None
        if not enabled:
            summaries_dir, use_wandb = None, False
        if summaries_dir:
            d = Path(summaries_dir)
            d.mkdir(parents=True, exist_ok=True)
            self.path = d / f"{run_name}.metrics.jsonl"
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project="avtubes", name=run_name, config=config or {})
            except Exception as e:  # wandb is best-effort observability
                print(f"[metrics] wandb unavailable ({e}); logging to JSONL only",
                      file=sys.stderr)
        self._t0 = time.time()

    def log(self, step: int | None = None, **metrics: Any) -> None:
        if not self.enabled:
            return
        rec = {"t": round(time.time() - self._t0, 3)}
        if step is not None:
            rec["step"] = step
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        line = json.dumps(rec)
        print(f"[metrics] {line}", flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self._wandb:
            self._wandb.log({k: v for k, v in rec.items() if k not in ("t",)})

    def log_image(self, name: str, image, step: int | None = None) -> None:
        """Log an overlay image (uint8 RGB): `images/<name>_<step>.jpg`
        under summaries_dir, and to wandb if attached."""
        import numpy as np

        arr = np.asarray(image)
        if self.path:
            from PIL import Image

            d = self.path.parent / "images"
            d.mkdir(exist_ok=True)
            suffix = f"_{step}" if step is not None else ""
            Image.fromarray(arr).save(d / f"{name}{suffix}.jpg")
        if self._wandb:
            self._wandb.log({name: self._wandb.Image(arr)})

    def close(self) -> None:
        if self._wandb:
            self._wandb.finish()
