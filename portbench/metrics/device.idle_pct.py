"""The device's idle share of the traced window: 100 x (1 - the union of
device activity / the window's wall), both from the same traced runs with
device activity alone recorded."""


def read(ctx):
    if ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
