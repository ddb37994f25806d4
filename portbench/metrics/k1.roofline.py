"""K1's share of its roofline: the frozen least time of the traced chunks'
int8 partials (``work/counts.py``: 2·rows·d·k at the int8 peak, or the
chunk's and centroids' bytes if larger) over the device time of K1's
launches in the traced slice.  Nothing when K1 did not run."""


def read(rec):
    t = sum(o["dur"] for o in rec["trace"]["ops"] if o["tag"] == "K1")
    if t <= 0:
        return None
    bound = rec["work"]["k1_chunk_bound_s"] * rec["slice"]["chunks"]
    return 100.0 * bound / (t * 1e-6)
