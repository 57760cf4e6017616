"""``solves_per_s``: graphs solved in the window over the window's
seconds, every tick and all of the window's time counted (host clock)."""


def read(run):
    if not run.tick_s:
        return None
    return len(run.tick_s) * run.cell.units() / run.window_s
