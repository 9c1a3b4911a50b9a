"""Mean megabytes (10^6 bytes) a PE pass copies from the device to the
host, the result (the program's counter `pe.d2h_bytes`)."""

from portbench import program


def read(run):
    return program.counter(run, "pe.d2h_bytes", 1e-6)
