"""k2_roofline.render (device trace): K2's (csrc/closest_hit.cu) HBM byte
bound over its device time in the traced window, in per cent
(roofline.py: each lane's ray and limit read once and its winner written
once; lanes from the dispatches' widths). A lower bound of the true
share: the scene tables and the walk's operations are not counted."""

from portbench.kernel_share import share


def read(run):
    return share(run, "closest_hit")
