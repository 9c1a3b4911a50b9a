"""Mean seconds a PE pass spends in the program's span `pe.coo`: the
sparse engine's host COO expansion of each batch and the final merge."""

from portbench import program


def read(run):
    return program.span_s(run, "pe.coo")
