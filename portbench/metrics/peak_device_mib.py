"""peak_device_mib: torch.cuda.max_memory_allocated over set-up and the
window, in MiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2**20 if ctx["peak_bytes"] else None
