"""consensus_ms: median host ms per job of consensus and coverage
(asm/consensus.py, asm/coverage.py): ec_consensus0 + utg_gfa + unzip_cov
+ unzip_consensus + final_cov + final_gfa (the two GFA writes are
consensus calls), from the
program's own SyncasmResult.timings."""
from portbench.core.stages import median_ms

KEYS = ('ec_consensus0', 'utg_gfa', 'unzip_cov', 'unzip_consensus', 'final_cov', 'final_gfa')


def read(ctx):
    return median_ms(ctx, KEYS)
