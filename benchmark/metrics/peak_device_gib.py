"""The program's peak of allocated device memory over set-up and the
window (torch.cuda.max_memory_allocated), in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
