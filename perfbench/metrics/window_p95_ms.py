"""The 95th percentile of every timed window's time, in ms, linearly
interpolated. A window's time runs from the previous window's end to its
own, on the device's clock (CUDA events recorded at each window's end;
``run_windows`` waits for the device after each), so it holds the host's
launches and waits as well as the kernels."""

import numpy as np


def read(ctx):
    if ctx.window_times.size == 0:
        return None
    return float(np.percentile(ctx.window_times, 95)) * 1e3
