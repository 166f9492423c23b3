"""Every frame whose map reached the host inside the window, over the window's length."""


def read(rec, metric):
    return rec.completed_in_window() / rec.run.seconds
