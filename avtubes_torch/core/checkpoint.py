"""Checkpoint save/restore (`torch.save` files).

Counterpart of `avtubes/core/checkpoint.py`.  A checkpoint is ONE FILE,
`<summaries_dir>/<tag>_ep<N>` (the JAX package writes a directory of that
name), holding `{params, opt_state, step, epoch}`: the model's `state_dict`,
the optimizer's and the schedule's `state_dict`s, the count of updates and
the epoch.  It is written to a temporary name and renamed, so a reader
never sees half a file, and read back with `weights_only=True`: tensors and
plain containers, nothing that runs code.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from avtubes_torch.train.state import TrainState


def checkpoint_path(summaries_dir: str | Path, tag: str, epoch: int) -> Path:
    return Path(summaries_dir).absolute() / f"{tag}_ep{epoch}"


def save_checkpoint(summaries_dir: str | Path, tag: str, epoch: int,
                    state: TrainState) -> Path:
    """Write {params, opt_state, step, epoch} of `state` to one file."""
    payload = {
        "params": state.model.state_dict(),
        "opt_state": {"optimizer": state.optimizer.state_dict(),
                      "scheduler": state.scheduler.state_dict()},
        "step": state.step,
        "epoch": epoch,
    }
    path = checkpoint_path(summaries_dir, tag, epoch)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


def restore_checkpoint(path: str | Path, state: TrainState) -> tuple[TrainState, int]:
    """Load a checkpoint into `state` (in place, onto the device its model
    lies on; strict about the parameter names); returns (state, epoch)."""
    device = next(state.model.parameters()).device
    payload = torch.load(Path(path).absolute(), map_location=device, weights_only=True)
    state.model.load_state_dict(payload["params"], strict=True)
    state.optimizer.load_state_dict(payload["opt_state"]["optimizer"])
    state.scheduler.load_state_dict(payload["opt_state"]["scheduler"])
    state.step = int(payload["step"])
    return state, int(payload["epoch"])


class PreemptionGuard:
    """Preemption-safe training: catch SIGTERM/SIGINT, let the current step
    finish, then the trainer saves a checkpoint and exits cleanly so a
    restart (`--use_pretrained`) resumes at the same epoch.

    Usage (inside the epoch loop):
        guard = PreemptionGuard()
        ...
        if guard.preempted:
            save_checkpoint(...); break

    Signal handlers are only installed in the main thread (a no-op guard
    otherwise, e.g. under test runners that use worker threads).
    """

    def __init__(self):
        import signal
        import threading

        self.preempted = False
        self._prev = {}
        if threading.current_thread() is not threading.main_thread():
            return
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):  # non-main interpreter contexts
                pass

    def _handler(self, signum, frame):
        print(f"[checkpoint] signal {signum}: finishing step, then "
              "checkpoint + clean exit")
        self.preempted = True

    def restore(self):
        """Reinstall the original handlers (call when training ends)."""
        import signal

        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass


def latest_checkpoint(summaries_dir: str | Path, tag: str) -> Path | None:
    """The `<tag>_ep<N>` file with the largest N, or None."""
    root = Path(summaries_dir)
    if not root.exists():
        return None
    cands = []
    for p in root.iterdir():
        if p.is_file() and p.name.startswith(f"{tag}_ep"):
            try:
                cands.append((int(p.name.split("_ep")[-1]), p))
            except ValueError:  # e.g. a leftover `.tmp<pid>` file
                continue
    return max(cands)[1] if cands else None
