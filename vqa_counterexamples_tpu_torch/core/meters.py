"""Streaming metric meters (port of ``core/meters.py``; reference
``vqa/lib/logger.py:85-137``)."""

from __future__ import annotations


class AvgMeter:
    """Running average; ``value()`` is the mean over all updates."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count

    def value(self):
        return self.avg


class SumMeter:
    """Running sum."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n

    def value(self):
        return self.sum


class ValueMeter:
    """Holds the last value only."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0

    def update(self, val):
        self.val = float(val)

    def value(self):
        return self.val
