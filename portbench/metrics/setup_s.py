"""Set-up: seconds from the process's start to the window's start
(torch and CUDA start, the round kernel's build or load, the inputs,
one short call of the cell's shape)."""


def read(w):
    return w.setup_s
