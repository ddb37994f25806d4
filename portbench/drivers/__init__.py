"""One driver a kind of entry: set-up, the program's first steps, the
window and the reference (``portbench.harness``)."""
