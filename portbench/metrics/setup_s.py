"""setup_s: from the process's first line to the window's opening: thread
pools, the sample made and written, the port imported, its libraries
loaded (built on a checkout's first run), two whole warm jobs."""


def read(ctx):
    return ctx["setup_s"]
