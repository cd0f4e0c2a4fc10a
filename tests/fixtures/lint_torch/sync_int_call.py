"""Planted violation: ``int()`` of a call that reads a tensor (the form
``return int(torch.argmax(logits[...]))``) inside tick-loop code.
`host-sync-in-hot-loop` must fire exactly once (``int`` of a host
builtin's result, or of a parameter's subscript, must NOT count)."""
import torch


class FakeEngine:
    def insert(self, toks, slot: int):
        n = int(len(toks))                  # a host builtin: fine
        self.pos[slot] = int(self.pos[slot]) + n    # a host table: fine
        logits = self.forward(toks)
        return int(torch.argmax(logits[0, n - 1]))  # device read: finding
