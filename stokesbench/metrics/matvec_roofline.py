"""The sweep-matvec's share of its roofline (`ops/matfree_node.py:
sweep_matvec`, K5) over its narrow launches (the GMRES matvec; the wide
set-up sweep has no operation count): least time by K5's counts for the
launched shape over the device time of the operations each call
launched, from the profiler's trace, in percent."""

from .. import roofline
from ._spans import roofline as share


def _bound(i):
    b = roofline.matvec_bound(i["kernel"], i["dtype"], i["nr"], i["n"], i["m"], i["shape"])
    return None if b is None else b[0]


def read(rec):
    return share(rec, "matvec", _bound)
