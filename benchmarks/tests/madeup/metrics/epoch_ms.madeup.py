"""epoch_ms.madeup: the card-clock ms of ``fusion.epoch.train`` per
``fusion.epoch``.  Made up for the contract's tests."""

from benchmarks.harness import spans


def read(summary, facts):
    return spans.device_ms_per(("fusion.epoch.train",), "fusion.epoch")
