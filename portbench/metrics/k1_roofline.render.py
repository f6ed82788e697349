"""k1_roofline.render (device trace): K1's (csrc/hitrec.cu) HBM byte bound
over its device time in the traced window, in per cent (roofline.py:
each lane's ray, distance and ids read once and its record written
once; lanes from the dispatches' widths). A lower bound of the true
share: rows and operations are not counted."""

from portbench.kernel_share import share


def read(run):
    return share(run, "hitrec")
