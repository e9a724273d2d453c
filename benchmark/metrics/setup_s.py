"""Process start to the first timed query, seconds."""


def read(run):
    return run.setup_s
