"""Planted violation: ``int()`` of a subscript of a tensor that its
function made (``t = f(...); int(t[i])``) inside tick-loop code.
`host-sync-in-hot-loop` must fire exactly once (``int`` of a subscript of
a parameter or a loop variable must NOT count)."""


class FakeEngine:
    def advance(self, positions, slots):
        for s in slots:
            self.pos[s] = int(positions[s])   # a host array: fine
        nxt = self.decode(slots)
        return int(nxt[0])                    # device read: finding
