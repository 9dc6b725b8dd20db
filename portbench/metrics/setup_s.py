"""setup_s (s, host clock): from the process's start to the window's: imports, the
card's context, the kernels built or found, seeded weights and inputs, the
warm-up of the cell's shapes (and a training cell's checked steps)."""


def read(rec):
    return rec["setup_s"]
