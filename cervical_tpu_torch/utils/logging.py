"""The config echo of the training CLI — the port's copy of ``show_config``
from ``cervical_tpu/utils/logging.py`` (reference:
``Segmentation/deeplabv3+/utils/utils.py:67-74``)."""

from __future__ import annotations


def show_config(**kwargs):
    """Print a boxed key/value table of the active configuration."""
    print("Configurations:")
    print("-" * 70)
    print("|%25s | %40s|" % ("keys", "values"))
    print("-" * 70)
    for key, value in kwargs.items():
        print("|%25s | %40s|" % (str(key), str(value)))
    print("-" * 70)
