"""Process start to the untraced window's opening: imports, the card's
start, the kernels' load or build, the program's start and its checked
steps."""


def read(ctx):
    return ctx.setup_s
