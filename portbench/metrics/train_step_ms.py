"""train_step_ms: the whole window over the training steps it completed,
host clock, synchronised at the end."""


def read(run):
    return 1e3 * run.window.seconds / run.window.items
