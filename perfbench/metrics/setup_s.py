"""``setup_s``: seconds from the process's start to the window's start
(imports, the CUDA context, the inputs made from the seed and copied to
the card, the warm tick), on the host clock."""


def read(run):
    return run.setup_s
