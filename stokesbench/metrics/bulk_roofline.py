"""The node sweep's share of its roofline (`ops/node_kernel.py:node_sweep`,
K1 or K3): the least time of the interactions each call sweeps (the
fewest-operation count of its Green's function against the card's peaks,
`roofline.bound`) over the device time of the operations the call
launched, from the profiler's trace, in percent."""

from .. import roofline
from ._spans import roofline as share


def read(rec):
    return share(rec, "bulk", lambda i: roofline.bound(i["kernel"], i["dtype"], i["nr"], i["n"], i["m"])[0])
