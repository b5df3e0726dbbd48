"""setup_s: seconds from the process start to the window, building,
compiling, data, weights and the first steps included."""


def read(r):
    return r.setup_s
