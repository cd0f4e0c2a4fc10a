"""Planted violation: ``bool()`` of a name bound to a device reduction
inside tick-loop code.  `host-sync-in-hot-loop` must fire exactly once
(``bool`` of a parameter must NOT count)."""


class FakeEngine:
    def resident(self, uid, tags, degraded):
        if bool(degraded):                  # a host flag: fine
            return False
        hit = (tags == uid).any()
        return bool(hit)                    # device read: finding
