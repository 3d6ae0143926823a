"""Images of every rank in the window's steps over the window's host time
(first step's launch to the synchronisation after the last)."""


def read(ctx):
    w = ctx.window
    return w["images"] / w["seconds"]
