"""Mean seconds a PE pass spends in the program's span `pe.drain`: the
host's wait for the device and the result's D2H (and the sparse
engine's host COO)."""

from portbench import program


def read(run):
    return program.span_s(run, "pe.drain")
