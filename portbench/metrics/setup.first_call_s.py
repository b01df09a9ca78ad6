"""Set-up, the engine: the first call of each public entry at each input
shape in this process (cuDNN's plan choice, the kernels' first launches,
a kernel build where one falls inside), the port's ``engine.first_call``
timer, seconds.  The warm-up makes every one of them."""

from portbench import spans

LAYER = "engine + models"
UNIT = "s"
MOVES = "setup_s"


def read(run):
    return spans.timer_s(run, "engine.first_call")
