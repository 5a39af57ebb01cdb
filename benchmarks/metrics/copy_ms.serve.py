"""copy_ms.serve: host-to-card plus card-to-host copy time on the card per
request in the traced window, in ms."""


def read(summary, facts):
    if facts.get("kind") != "serve" or not facts.get("requests"):
        return None
    s = summary.copy_s.get("htod", 0.0) + summary.copy_s.get("dtoh", 0.0)
    if s <= 0:
        return None
    return 1e3 * s / facts["requests"]
