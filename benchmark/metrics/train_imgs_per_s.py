"""Images of the global batch trained in the window over the window's
seconds (host clock, from the first step's issue to the fence after the
last); on a mesh, all cards' images together."""


def read(traces, ctx):
    return ctx["window_calls"] * ctx["images_per_call"] / ctx["window_s"]
