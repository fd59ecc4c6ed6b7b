"""Two gloo processes running the port's multi-device path over
torch.distributed (the cross-process collectives that one process cannot
exercise): the sharded collection on a 2-shard mesh (one shard per
rank), K11, the variable-length allgather, the range-partitioned pair
reduce with its replicated-stream guard, and full syncasm(shards=2) with
alignment and EC sharded across the ranks.  Every rank's DB must equal
the single-device DB, and every rank's ``.utg.final.gfa`` must equal the
port's single-process run and oatk_tpu's.  The workers import no JAX."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from genome_sim import random_genome, sample_reads, write_reads

WORKER = r"""
import os, sys
import numpy as np

rank, port, fa, golden = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
from oatk_tpu_torch.dist import comm
comm.initialize(rank, 2, f"tcp://localhost:{port}", backend="gloo")
assert comm.process_count() == 2 and comm.process_index() == rank

from oatk_tpu_torch.asm.pipeline import load_reads, syncasm
from oatk_tpu_torch.dist import make_mesh, sharded_extract_count_step
from oatk_tpu_torch.dist.sharded_db import load_and_extract_sharded
from oatk_tpu_torch.dist.stages import sharded_pair_reduce
from oatk_tpu_torch.index.syncmer_db import collect_syncmer_db

# 1. the variable-length allgather: other lengths, dtypes, shapes, empties
parts = comm.allgather_var(np.arange(3 + 5 * rank, dtype=np.uint64) << np.uint64(60))
assert [len(p) for p in parts] == [3, 8] and parts[1].dtype == np.uint64
assert np.array_equal(parts[rank], np.arange(3 + 5 * rank, dtype=np.uint64) << np.uint64(60))
two = comm.allgather_var(np.full((rank, 3), rank, np.int64))
assert [p.shape for p in two] == [(0, 3), (1, 3)] and two[1].sum() == 3
assert comm.all_ranks_ok(True) and not comm.all_ranks_ok(rank == 0)
print(f"rank {rank} GATHER OK", flush=True)

# 2. sharded collection: one shard per rank, DB equal to the single-device DB
mesh = make_mesh(2, "cpu")
assert mesh.local_shards() == [rank]
db2, coll = load_and_extract_sharded([fa], 151, 13, mesh)
scm2 = coll.build(db2)
db1 = load_reads([fa], 151, 13, device="cpu")
scm1 = collect_syncmer_db(db1)
assert scm1.n == scm2.n > 0
for f in ("h", "s", "cov", "mp_flat", "mp_off"):
    assert np.array_equal(getattr(scm1, f), getattr(scm2, f)), f
for r1, r2 in zip(db1.reads, db2.reads):
    for f in ("m_pos", "s_mer", "k_mer"):
        assert np.array_equal(getattr(r1, f), getattr(r2, f)), (r1.sid, f)
assert sum(coll.occ_per_shard) == db2.total_syncmers() and coll.exchange_bytes > 0
print(f"rank {rank} DB OK n={scm2.n}", flush=True)

# 3. K11 across the ranks: counts equal numpy's over the same rows
with open(fa) as f:
    recs = [ln.strip() for ln in f if not ln.startswith(">")][:12]
seq = np.zeros((12, max(len(r) for r in recs)), np.uint8)
lens = np.zeros(12, np.int32)
for i, r in enumerate(recs):
    seq[i, : len(r)] = np.frombuffer(r.encode(), np.uint8)
    lens[i] = len(r)
nd, hist, n_sel, ndrop = sharded_extract_count_step(seq, lens, 151, 13, 64, mesh)
os.environ["OATK_TPU_COUNT"] = "host"  # the reads keep their raw hashes
hs = np.concatenate([r.k_mer for r in load_reads([fa], 151, 13, device="cpu").reads[:12]])
del os.environ["OATK_TPU_COUNT"]
_, counts = np.unique(hs, return_counts=True)
assert int(n_sel.sum()) == len(hs) and int(nd.sum()) == len(counts) and not ndrop.any()
assert (hist == np.bincount(np.clip(counts, 0, 63), minlength=64)).all()
print(f"rank {rank} K11 OK", flush=True)

# 4. pair reduce across the ranks, and the guard on a stream that differs
rng = np.random.default_rng(4)
keys = rng.integers(0, np.iinfo(np.uint64).max, 9000, dtype=np.uint64, endpoint=True)
keys = np.concatenate([keys, keys[:2000]])
pk, cnt = sharded_pair_reduce(keys)
u, c = np.unique(keys, return_counts=True)
assert np.array_equal(pk, u) and np.array_equal(cnt, c)
try:
    sharded_pair_reduce(keys[: len(keys) - rank])
except RuntimeError as e:
    assert "different pair streams" in str(e)
    print(f"rank {rank} PAIR OK", flush=True)

# 5. full syncasm: --shards 2, and the unsharded loader with alignment
# and EC still sharded across the ranks
out_dir = os.path.dirname(fa)
syncasm([fa], k=151, s=13, min_k_cov=3, do_ec=True, do_unzip=3,
        out=os.path.join(out_dir, f"mesh_p{rank}"), shards=2, device="cpu")
syncasm([fa], k=151, s=13, min_k_cov=3, do_ec=True, do_unzip=3,
        out=os.path.join(out_dir, f"local_p{rank}"), device="cpu")
want = open(golden, "rb").read()
for name in ("mesh", "local"):
    got = open(os.path.join(out_dir, f"{name}_p{rank}.utg.final.gfa"), "rb").read()
    assert got == want and b"\nS\t" in got, name
print(f"rank {rank} SYNCASM OK", flush=True)
comm.shutdown()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """tests/test_sharded_db.py's GFA set (a(7 kbp) + r(2.2 kbp) +
    b(6 kbp) + r at 14x of 2.2 kbp reads; the set of
    tests/test_multiprocess_dist.py cleans down to an empty graph at
    c=3).  The port's single-process GFA must equal oatk_tpu's; returns
    the two ranks' outputs."""
    import oatk_tpu.asm.pipeline as J
    import oatk_tpu_torch.asm.pipeline as T

    d = tmp_path_factory.mktemp("mp")
    rng = np.random.default_rng(23)
    a, r, b = random_genome(rng, 7000), random_genome(rng, 2200), random_genome(rng, 6000)
    fa = d / "reads.fa"
    write_reads(str(fa), sample_reads(rng, a + r + b + r, coverage=14, read_len=2200,
                                      err_rate=0.002))
    kw = dict(k=151, s=13, min_k_cov=3, do_ec=True, do_unzip=3)
    J.syncasm([str(fa)], out=str(d / "jax"), **kw)
    T.syncasm([str(fa)], out=str(d / "golden"), device="cpu", **kw)
    golden = d / "golden.utg.final.gfa"
    assert golden.read_bytes() == (d / "jax.utg.final.gfa").read_bytes()
    worker = d / "worker.py"
    worker.write_text(WORKER)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).parent.parent))
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(r), port, str(fa), str(golden)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for r in range(2)
    ]
    import time

    deadline = time.monotonic() + 300
    outs = []
    for p in procs:
        try:
            out = p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0] + "\n[timed out after 300 s]"
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "\n".join(
            f"rank {i} (exit {q.returncode}):\n{o[-3000:]}" for i, (q, o) in enumerate(zip(procs, outs)))
    return outs


@pytest.mark.parametrize("what", ["GATHER", "DB", "K11", "PAIR", "SYNCASM"])
def test_two_process(two_ranks, what):
    for r, out in enumerate(two_ranks):
        assert f"rank {r} {what} OK" in out, out[-3000:]
