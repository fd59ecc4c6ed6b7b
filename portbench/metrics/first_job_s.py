"""first_job_s: host seconds of the first set-up job (extension loads,
CUDA context and first-use costs on top of a steady job)."""


def read(ctx):
    return ctx["first_job_s"]
