"""Planted violation: ``.cpu()`` inside tick-loop code (a device->host copy
that waits for the stream).  `host-sync-in-hot-loop` must fire exactly once
(moving a tensor TO a device with ``.to`` must NOT count)."""


class FakeScheduler:
    def tick(self, handle, toks, device):
        staged = toks.to(device)            # host->device: fine
        return handle.cpu(), staged         # device->host: finding
