"""Process start to the window's first request: imports, the card, the
kernels (built on the first run in a checkout), the corpus, the build and
the warm-up."""


def read(ctx):
    return ctx.setup_s
