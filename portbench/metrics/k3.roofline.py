"""K3's share of its roofline: the frozen least time of the traced epochs'
ratings (``work/counts.py``: 12·rank f32 operations a rating, or each
rating and each touched W and H row moved once if larger) over the device
time of K3's launches in the traced slice.  Nothing when K3 did not run."""


def read(rec):
    t = sum(o["dur"] for o in rec["trace"]["ops"] if o["tag"] == "K3")
    if t <= 0:
        return None
    bound = rec["work"]["epoch_bound_s"] * rec["slice"]["epochs"]
    return 100.0 * bound / (t * 1e-6)
