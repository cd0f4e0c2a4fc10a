"""Planted violation: ``.tolist()`` of a device tensor inside tick-loop
code.  `host-sync-in-hot-loop` must fire exactly once (a host list built
with ``list()`` must NOT count)."""


class FakeScheduler:
    def tick(self, handle):
        order = list(range(4))              # host: fine
        return handle.tolist(), order       # device->host: finding
