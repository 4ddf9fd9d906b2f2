"""Real-time factor: the timed window's wall time over the model time its
windows simulated (a window is ``D`` cycles of ``dt``), over all windows
and all the time of the window."""


def read(ctx):
    if ctx.n_timed == 0:
        return None
    return ctx.wall_s / (ctx.n_timed * ctx.model_s_per_window)
