"""Seconds of ``LDA.set_tokens`` (the host pack, the install on the card
and K4's entry plans), timed on the host clock around the call in
set-up."""


def read(rec):
    return rec["host"]["prep_s"]
