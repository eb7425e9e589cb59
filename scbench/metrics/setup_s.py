"""setup_s: seconds from the process's start (before torch is imported)
to the start of the window: imports, the kernel build or load, the
deployment's set-up, the inputs made from the seed and the warm-up."""


def read(record):
    return record.setup_s
