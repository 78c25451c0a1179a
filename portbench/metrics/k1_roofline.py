"""K1 (`screen_codes_kernel`): share of the roofline of every screen
dispatch of the traced window (roofline/screen_codes.py)."""

from portbench.metrics._roofline import share


def read(rec):
    return share(rec, "screen_codes")
