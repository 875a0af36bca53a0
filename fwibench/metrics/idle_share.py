"""The share of the window in which no operation ran on the card, in %:
1 less the union of the device records over the window."""


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_s() / ctx.window_s)
