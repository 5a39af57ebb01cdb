"""finish_ms.serve: the card-clock ms of the predictor's
``predict.unletterbox``, ``predict.argmax`` and ``predict.download`` spans
together per ``predict.request`` in the traced window.  Nothing where the
program records no such spans."""

from benchmarks.harness import spans


def read(summary, facts):
    return spans.device_ms_per(("predict.unletterbox", "predict.argmax",
                                "predict.download"), "predict.request")
