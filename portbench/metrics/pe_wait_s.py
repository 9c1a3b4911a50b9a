"""Mean seconds a PE pass spends in the program's span `pe.wait`: the
sparse engine's host blocked on the card for a batch's saturated
lists."""

from portbench import program


def read(run):
    return program.span_s(run, "pe.wait")
