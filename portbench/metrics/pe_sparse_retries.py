"""Mean cap-overflow retries of the sparse engine a PE pass, each of
which redoes the whole pass (the program's counter
`pe.sparse_retries`)."""

from portbench import program


def read(run):
    return program.counter(run, "pe.sparse_retries")
