"""Seconds from the process's start to the first timed call (host clock):
loading, making weights and traffic on the card, building kernels on a
first run, and warming up every shape the window uses."""


def read(traces, ctx):
    return ctx["setup_s"]
