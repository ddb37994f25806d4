"""The share of the traced slice in which no operation ran on the card."""


def read(rec):
    tr = rec["trace"]
    if not tr["ops"] or tr["window_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - tr["busy_s"] / tr["window_s"])
