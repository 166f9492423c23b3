"""Set-up: process start to the window's first due request or frame
(imports, weights, kernel libraries, cuDNN's algorithm search, warm-up)."""


def read(rec, metric):
    return rec.run.setup_s
