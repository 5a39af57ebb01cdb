"""idle_share.train: the share of the traced window in which no kernel,
copy or set ran on the card (the union of device intervals), in %."""


def read(summary, facts):
    if facts.get("kind") != "train" or summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
