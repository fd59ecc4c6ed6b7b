"""ec_trip_ms: median host ms per job that error correction's device
route waits in its rounds' trips to the card (upload, K2's launch, the
read-back and the synchronise, summed over the rounds): the program's
``ec.wf.trip``.  Nothing where the program records no such key."""
from portbench.core.stages import median_ms

KEYS = ("ec.wf.trip",)


def read(ctx):
    return median_ms(ctx, KEYS)
