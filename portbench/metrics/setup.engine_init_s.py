"""Set-up, the engine (``FaceEngine.__init__``): the modules built, the
given weights loaded, the folds and the cast, the port's ``engine.init``
timer in this process, seconds."""

from portbench import spans

LAYER = "engine + models"
UNIT = "s"
MOVES = "setup_s"


def read(run):
    return spans.timer_s(run, "engine.init")
