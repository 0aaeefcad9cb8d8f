"""Lane-rounds completed in the window over the window's seconds (E = 1:
FL rounds a second). A round counts when its evaluation has returned
after a ``synchronize``; the window opens at the warm-up's last such
stamp and closes at the first one ``--seconds`` later."""
KIND, UNIT, SOURCE, BETTER = "end_to_end", "rounds/s", "host_clock", "higher"


def read(r):
    t = r.timing
    return t.window_rounds / t.window_s if t.window_s > 0 else None
