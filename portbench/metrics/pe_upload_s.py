"""Mean seconds a PE pass spends in the program's span `pe.upload`: the
batches' H2D, from pageable memory, so with the host's wait on the
stream."""

from portbench import program


def read(run):
    return program.span_s(run, "pe.upload")
