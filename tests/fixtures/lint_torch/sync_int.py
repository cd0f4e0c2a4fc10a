"""Planted violation: ``int()`` of a name bound to what a call returned (a
tensor) inside tick-loop code.  `host-sync-in-hot-loop` must fire exactly
once (``int`` of a parameter, the host's normalisation of a host value,
must NOT count)."""


class FakeEngine:
    def adopt(self, uid: int, pos: int, tags):
        self.pos = int(pos)                 # a host value: fine
        n = tags.sum()
        return int(n)                       # device read: finding
