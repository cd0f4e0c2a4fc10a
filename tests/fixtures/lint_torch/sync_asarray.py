"""Planted violation: ``np.asarray`` of a live buffer inside tick-loop
code.  `host-sync-in-hot-loop` must fire exactly once (``np.asarray`` of a
host list literal must NOT count)."""
import numpy as np


class FakeScheduler:
    def tick(self, handle):
        slots = np.asarray([0, 1, 2])       # host literal: fine
        return np.asarray(handle), slots    # device->host: finding
