"""forward_ms.serve: the card-clock ms of the predictor's
``predict.forward`` span (the serving forward and its softmax) per
``predict.request`` in the traced window.  Nothing where the program
records no such span."""

from benchmarks.harness import spans


def read(summary, facts):
    return spans.device_ms_per(("predict.forward",), "predict.request")
