"""The 95th percentile of the wall times of all frames in the window
(linear interpolation between order statistics)."""

import numpy as np


def read(rec):
    return float(np.percentile(rec.frame_seconds, 95)) if rec.frame_seconds else None
