"""Console logging of the training CLIs — the port's copy of
``cervical_tpu/utils/logging.py``: :class:`Logger` tees stdout to a
timestamped file (reference: ``MultiModal Prediction/Four_Modal/
util.py:50-67``), :func:`show_config` echoes the configuration
(``Segmentation/deeplabv3+/utils/utils.py:67-74``)."""

from __future__ import annotations

import os
import sys
import time


class Logger:
    """Tee a stream (stdout by default) to ``log_dir/YYYY-MM-DD-HH-MM.log``."""

    def __init__(self, log_dir="log", stream=None, filename=None):
        self.terminal = stream if stream is not None else sys.stdout
        os.makedirs(log_dir, exist_ok=True)
        if filename is None:
            filename = time.strftime("%Y-%m-%d-%H-%M") + ".log"
        self.path = os.path.join(log_dir, filename)
        self.log = open(self.path, "a", encoding="utf-8")

    def write(self, message):
        self.terminal.write(message)
        self.log.write(message)
        self.log.flush()

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def close(self):
        self.log.close()


def show_config(**kwargs):
    """Print a boxed key/value table of the active configuration."""
    print("Configurations:")
    print("-" * 70)
    print("|%25s | %40s|" % ("keys", "values"))
    print("-" * 70)
    for key, value in kwargs.items():
        print("|%25s | %40s|" % (str(key), str(value)))
    print("-" * 70)
