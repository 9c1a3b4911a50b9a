"""Process start to window start: loading, warm-up, and on a checkout's
first run the kernel build and the dataset's generation."""


def read(run):
    return run.setup_s
