"""Images embedded in the window over the window's seconds: every call of the
window, timed by the host's clock from the first call's issue to the fence
after the last."""


def read(traces, ctx):
    return ctx["window_calls"] * ctx["images_per_call"] / ctx["window_s"]
