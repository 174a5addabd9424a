"""Set-up: from the process's start to the window's (imports, the card's
context, the kernel libraries loaded or built, the assets made, the
program's set-up and the warm-up)."""


def read(run):
    return run.setup_s
