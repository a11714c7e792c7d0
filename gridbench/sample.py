"""A fixed-size sample, drawn from the seed, of groups of records that arrive
one by one in a window of unknown length (reservoir sampling): every group
has the same chance to be kept, and memory stays bounded."""

from __future__ import annotations

import random


class Reservoir:
    def __init__(self, size: int, seed: int):
        self.size = int(size)
        self.rng = random.Random(seed)
        self.slots: list = []  # (arrival index, group)
        self.seen = 0

    def offer(self) -> int | None:
        """The slot the next group goes to, or None if it is not kept."""
        i = self.seen
        self.seen += 1
        if i < self.size:
            self.slots.append((i, []))
            return len(self.slots) - 1
        j = self.rng.randrange(i + 1)
        if j < self.size:
            self.slots[j] = (i, [])
            return j
        return None

    def add(self, slot: int, record: dict) -> None:
        self.slots[slot][1].append(record)

    def records(self) -> list:
        """The kept groups' records, in arrival order."""
        return [r for _, group in sorted(self.slots, key=lambda s: s[0]) for r in group]
