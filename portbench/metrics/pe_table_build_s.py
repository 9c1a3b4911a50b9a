"""Mean seconds a PE pass spends in the program's span
`pe.table_build`: the host k-mer table build (C++ hash and sort, then
its tail)."""

from portbench import program


def read(run):
    return program.span_s(run, "pe.table_build")
