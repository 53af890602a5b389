"""frames_per_s: frames (or files) delivered to the host over all the time
of the window, host clock."""


def read(run):
    return run.window.items / run.window.seconds
