"""Planted violation: ``torch.cuda.synchronize()`` inside tick-loop code.
`host-sync-in-hot-loop` must fire exactly once (reading the current stream
must NOT count)."""
import torch


class FakeScheduler:
    def tick(self, handle):
        stream = torch.cuda.current_stream()    # no wait: fine
        torch.cuda.synchronize()                # host waits: finding
        return handle, stream
