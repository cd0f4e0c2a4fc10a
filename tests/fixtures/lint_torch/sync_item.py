"""Planted violation: ``.item()`` inside tick-loop code.  Linted AS IF it
were src/repro_torch/sched/scheduler.py; `host-sync-in-hot-loop` must fire
exactly once (the host->device copy must NOT count)."""
import torch


class FakeScheduler:
    def tick(self, handle, toks):
        staged = torch.as_tensor(toks)      # host->device: fine
        return handle.item(), staged        # device sync mid-tick: finding
