"""Planted violation: ``float()`` of a live buffer inside tick-loop code.
`host-sync-in-hot-loop` must fire exactly once (``float`` of a literal
must NOT count)."""


class FakeScheduler:
    def tick(self, loss):
        scale = float(2)                    # a constant: fine
        return float(loss) * scale          # device read: finding
