"""Planted violation: ``bool()`` of a device reduction called in place
(``bool(mask.any())``) inside tick-loop code.  `host-sync-in-hot-loop`
must fire exactly once (``bool`` of a comparison of host values must NOT
count)."""


class FakeEngine:
    def any_resident(self, uid, tags):
        if bool(uid < len(self.store)):      # host values: fine
            mask = tags == uid
            return bool(mask.any())           # device read: finding
        return False
