"""Peaks of the card and the work of the model and its kernels, counted
from shapes alone, so a count stays whatever implements the work."""

import json
import os

_HERE = os.path.dirname(os.path.abspath(__file__))


def peaks() -> dict:
    with open(os.path.join(_HERE, "peaks.json")) as f:
        return json.load(f)
