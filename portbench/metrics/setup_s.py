"""Seconds from the process's start (the first statement of
`portbench/run.py`) to the first timed step: imports, building the
program, loading the seeded weights, the first steps (the reference
follows three of them), kernel builds and graph captures."""


def read(record):
    return record.host["setup_s"]
