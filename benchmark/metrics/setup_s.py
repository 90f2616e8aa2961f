"""Set-up seconds: the process's start to the window's, the program's
import, the card's context, the kernels' library (built in a checkout's
first run), the pool and the warm pass."""


def read(run):
    return run.setup_s
