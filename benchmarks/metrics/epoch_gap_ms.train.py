"""epoch_gap_ms.train: ``seg.epoch``'s self time on the card's clock per
epoch in the traced window, in ms: its seconds less those of its two
parts, ``seg.epoch.train`` and ``seg.epoch.val`` (the drain bubbles after
each, and the shuffle).  Nothing where the program records no such
spans."""

from benchmarks.harness import spans


def read(summary, facts):
    epoch = spans.device_ms_per(("seg.epoch",), "seg.epoch")
    parts = spans.device_ms_per(("seg.epoch.train", "seg.epoch.val"),
                                "seg.epoch")
    if epoch is None or parts is None:
        return None
    return epoch - parts
