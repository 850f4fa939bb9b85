"""The share of the window in which no kernel or copy ran on the card (the
union of the profiler's device intervals against the window's length)."""


def read(window, outcome):
    if not window.kernels:
        return None
    return 100.0 * (1.0 - window.busy_s / window.window_s)
