"""Waits of the host for the card (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize`` among the profiler's
runtime calls) per accepted step: each is a read-back the host loop makes
the card drain for, such as the CFL bound's."""


def read(window, outcome):
    if not window.runtime:
        return None
    return window.syncs() / outcome.units
