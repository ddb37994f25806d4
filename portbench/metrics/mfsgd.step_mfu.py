"""The whole epoch's share of the card's peak: an epoch's frozen least
time (``work/counts.py``: 12·rank f32 operations a rating at K3's route
peak, the CUDA cores' 67 TFLOP/s, or its bytes at the HBM rate if larger)
over the traced run's mean epoch time on the host clock (the window's
epochs outside the traced slice)."""


def read(rec):
    if not rec["trace"]["ops"]:
        return None
    return 100.0 * rec["work"]["epoch_bound_s"] / rec["host"]["epoch_s"]
