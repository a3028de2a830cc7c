"""setup_s (s, host clock): from the start of the process (the imports)
to the end of the first call at the cell's shapes, which loads or builds
the kernel library, makes the pool and captures the graphs."""


def read(run):
    return run.setup_s
