"""val_share.train: the card-clock seconds of the epoch's
``seg.epoch.val`` span over its ``seg.epoch`` span in the traced window, in
%.  Nothing where the program records no such spans."""

from benchmarks.harness import spans


def read(summary, facts):
    val = spans.device_ms_per(("seg.epoch.val",), "seg.epoch")
    epoch = spans.device_ms_per(("seg.epoch",), "seg.epoch")
    if val is None or epoch is None or epoch <= 0:
        return None
    return 100.0 * val / epoch
