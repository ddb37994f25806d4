"""The whole sweep's share of the card's peak: a sweep's frozen least time
(``work/lda.py``: 7 f32 operations a real token and topic at the CUDA
cores' 67 TFLOP/s, or its bytes at the HBM rate if larger) over the
traced run's mean sweep time on the host clock (the window's sweeps
outside the traced slice)."""


def read(rec):
    if not rec["trace"]["ops"]:
        return None
    return 100.0 * rec["work"]["sweep_bound_s"] / rec["host"]["sweep_s"]
