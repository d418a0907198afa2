"""Share of the traced window in which no operation ran on the card
(``busy_s`` over ``window_s``), in a cell that reports ``frames_per_s``."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
