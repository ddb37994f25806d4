"""K4's share of its roofline: the frozen least time of the traced sweeps'
real tokens (``work/lda.py``: 7 f32 operations a real token and topic at
the CUDA cores' peak, or the tables and tokens moved once if larger) over
the device time of K4's launches in the traced slice.  Padded slots are
no work: a kernel that stops sampling them reads higher.  Nothing when K4
did not run."""


def read(rec):
    t = sum(o["dur"] for o in rec["trace"]["ops"] if o["tag"] == "K4")
    if t <= 0:
        return None
    bound = rec["work"]["sweep_bound_s"] * rec["slice"]["sweeps"]
    return 100.0 * bound / (t * 1e-6)
