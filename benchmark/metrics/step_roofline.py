"""The least time one H100 needs for the window's work (the larger of its
bytes over 3.35 TB/s and its operations over the FP32 peak, counted from
the cell's shapes by ``work.py``), as a share of the time the card was busy
in the window. No kernel's name enters it."""


def read(window, outcome):
    busy = window.busy_s
    if busy <= 0:
        return None
    return 100.0 * outcome.least_s_per_unit * outcome.units / busy
