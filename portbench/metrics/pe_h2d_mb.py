"""Mean megabytes (10^6 bytes) a PE pass copies from the host to the
device, the table and the batches (the program's counter
`pe.h2d_bytes`)."""

from portbench import program


def read(run):
    return program.counter(run, "pe.h2d_bytes", 1e-6)
