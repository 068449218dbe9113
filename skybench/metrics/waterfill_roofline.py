"""waterfill_roofline (kernels): the least time the slice's
water-filling solves need over the device time of its water-filling
kernels. The solves are those the frozen reference makes on the same
inputs, each with its rounds (``roofline.counting_solves``); a solve's
least time is the larger of its bytes at the memory rate and its float64
operations at the float64 peak (``roofline.least_seconds``)."""

from skybench import roofline

KERNELS = "waterfill"


def read(r):
    if r.slice is None or not r.slice_solves:
        return None
    us = sum(e - s for name, s, e in r.slice.kernels() if KERNELS in name)
    if not us:
        return None
    return 100.0 * roofline.least_seconds(r.slice_solves) / (us * 1e-6)
