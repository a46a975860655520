"""reads_per_s: queries classified over the whole window over its wall
time (a pair is one query); the window ends when the last result is on
the host."""


def read(run):
    w = run.win
    return w["queries"] / (w["t1"] - w["t0"])
