"""ec_driver_ms: median host ms per job of EC's device driver
(csrc/ec_lockstep.c through asm/ec_lockstep.py): layout + pack + unpack
of kernels/wf_ed.py's wf_ed_lockstep.last.  Nothing where EC runs no
lockstep rounds."""
from portbench.core.stages import driver_ms


def read(ctx):
    return driver_ms(ctx)
