"""Synchronised wall time of set-up's `MemoryService.build` over the
corpus: k-means and the packing of the lists."""


def read(ctx):
    return ctx.build_s
