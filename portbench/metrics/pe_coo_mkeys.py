"""Mean millions of COO keys (pair and same-end) a PE pass expands on
the host before making them unique (the program's counter
`pe.coo_keys`)."""

from portbench import program


def read(run):
    return program.counter(run, "pe.coo_keys", 1e-6)
