"""Mean seconds a PE pass spends in the program's span `pe.pack`:
the host packing and padding of the batches."""

from portbench import program


def read(run):
    return program.span_s(run, "pe.pack")
