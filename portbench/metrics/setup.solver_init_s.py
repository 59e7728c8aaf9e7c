"""setup.solver_init_s: the wall seconds of the program's build (the
factorization and the driver's init), ending in a device sync."""


def read(ctx):
    return ctx.solver_init_s
