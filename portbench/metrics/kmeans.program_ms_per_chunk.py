"""Device milliseconds a chunk of every operation the program ran in the
traced slice: all device work not launched inside the benchmark's
``portbench.gen`` range (the quantize, cast, sum of |x|^2 and partials
passes, whatever implements them).  Nothing without device records."""


def read(rec):
    ops = rec["trace"]["ops"]
    if not ops:
        return None
    t = sum(o["dur"] for o in ops if not o["gen"])
    return t * 1e-3 / rec["slice"]["chunks"]
