"""The whole Lloyd step's share of the card's peak: an epoch's frozen
least time (``work/counts.py``: 2·n·d·k + n·d at the precision's peak, or
its bytes at the HBM rate if larger) over the traced run's mean time an
epoch on the host clock (the window's epochs outside the traced one)."""


def read(rec):
    if not rec["trace"]["ops"]:
        return None
    return 100.0 * rec["work"]["epoch_bound_s"] / rec["host"]["epoch_s"]
