"""``setup_s``: seconds from the process's start to the end of the warm-up
(imports, the kernels' build or load, the warm-up input and call)."""


def read(run):
    return run.setup_s
