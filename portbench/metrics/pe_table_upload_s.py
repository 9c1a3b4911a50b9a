"""Mean seconds a PE pass spends in the program's span
`pe.table_upload`: the host sortfill payloads or record, and the
table's H2D."""

from portbench import program


def read(run):
    return program.span_s(run, "pe.table_upload")
