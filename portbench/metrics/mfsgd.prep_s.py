"""Seconds of ``MFSGD.set_ratings`` (the partition and K3's level
schedules), timed on the host clock around the call in set-up."""


def read(rec):
    return rec["host"]["prep_s"]
