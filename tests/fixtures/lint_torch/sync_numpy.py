"""Planted violation: ``.numpy()`` inside tick-loop code.
`host-sync-in-hot-loop` must fire exactly once (a host array made with
``np.zeros`` must NOT count)."""
import numpy as np


class FakeScheduler:
    def tick(self, handle):
        mask = np.zeros(4, bool)            # host: fine
        return handle.numpy(), mask         # device->host: finding
