"""Set-up, the kernels (``kernels/build.py``): loading the CUDA kernels'
and the host codec's libraries, with the nvcc and g++ builds where this
checkout has none yet, the port's ``kernels.build`` timer in this process,
seconds."""

from portbench import spans

LAYER = "kernels"
UNIT = "s"
MOVES = "setup_s"


def read(run):
    return spans.timer_s(run, "kernels.build")
