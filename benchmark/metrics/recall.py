"""recall (share): the mean recall at the cell's k of every reply answered
in the window, against the exact top k among the rows its filter admits."""

import numpy as np


def read(run):
    r = run.recall[run.answered()]
    r = r[~np.isnan(r)]
    return float(r.mean()) if r.size else None
