"""mfu.serve: the serve cell's counted model work in the traced window
(`facts["work_flops"]`, from `benchmarks/rooflines/flops.py`) over the
window's length times the card's bf16 dense peak, in %."""

from benchmarks.rooflines import peaks


def read(summary, facts):
    if facts.get("kind") != "serve" or summary.window_s <= 0:
        return None
    return 100.0 * facts["work_flops"] / (summary.window_s
                                          * peaks()["bf16_flops"])
