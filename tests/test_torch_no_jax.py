"""The card's machine has no JAX.  In a subprocess whose import system
refuses ``jax`` (and so ``oatk_tpu``, whose __init__ imports it), every
oatk_tpu_torch module must import, and the syncasm and oatk CLIs must
run on a small FASTA with --device cpu (oatk with the stub nhmmscan and
EC's wavefront on the device backend)."""
import os
import pathlib
import subprocess
import sys

import numpy as np

from genome_sim import random_genome, sample_reads, write_reads

REPO = pathlib.Path(__file__).resolve().parent.parent

_CHILD = r"""
import importlib, pkgutil, sys

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax.") or name == "jaxlib" or name.startswith("jaxlib."):
            raise ImportError(f"blocked: {name}")
        return None

for m in [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))]:
    del sys.modules[m]
sys.meta_path.insert(0, _NoJax())

import oatk_tpu_torch
names = [m.name for m in pkgutil.walk_packages(oatk_tpu_torch.__path__, "oatk_tpu_torch.")]
for n in names:
    importlib.import_module(n)
assert "jax" not in sys.modules and "oatk_tpu" not in sys.modules
print("IMPORTED", len(names))

cli = importlib.import_module("oatk_tpu_torch.cli." + sys.argv[1])
rc = cli.main(sys.argv[2:])
assert "jax" not in sys.modules and "oatk_tpu" not in sys.modules
from oatk_tpu_torch.asm.ec import read_error_correction
print("WF_CALLS", read_error_correction.wf_calls)
print("RC", rc)
sys.exit(rc)
"""


def test_port_runs_without_jax(tmp_path):
    rng = np.random.default_rng(3)
    g = random_genome(rng, 9000)
    fa = tmp_path / "r.fa"
    write_reads(str(fa), sample_reads(rng, g, coverage=12, read_len=1500, err_rate=0.002))
    out = tmp_path / "asm"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-c", _CHILD, "syncasm", str(fa), "-k", "51", "-s", "11", "-c", "2",
         "--device", "cpu", "-o", str(out)],
        capture_output=True, text=True, cwd=str(tmp_path), env=env, timeout=300,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "IMPORTED" in r.stdout and "RC 0" in r.stdout
    for suf in (".utg.gfa", ".utg.final.gfa"):
        text = (tmp_path / f"asm{suf}").read_text()
        assert "\nS\t" in text


def test_port_oatk_runs_without_jax(tmp_path):
    from test_tools_parity import FAKE_NHMMSCAN

    rng = np.random.default_rng(5)
    g = random_genome(rng, 12000)
    fa = tmp_path / "r.fa"
    write_reads(str(fa), sample_reads(rng, g, coverage=14, read_len=2500, err_rate=0.002))
    exe = tmp_path / "fake_nhmmscan"
    exe.write_text(FAKE_NHMMSCAN.replace("gene$i", "nad$i"))
    exe.chmod(0o755)
    (tmp_path / "fake.hmm").write_text("dummy\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OATK_TPU_WF_BACKEND="device")
    r = subprocess.run(
        [sys.executable, "-c", _CHILD, "oatk", str(fa), "-k", "151", "-s", "13", "-c", "3",
         "-m", str(tmp_path / "fake.hmm"), "--nhmmscan", str(exe), "--device", "cpu",
         "-o", str(tmp_path / "asm")],
        capture_output=True, text=True, cwd=str(tmp_path), env=env, timeout=300,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "RC 0" in r.stdout
    assert "error blocks" in r.stderr  # EC ran, through wf_ed_core_device
    assert int(r.stdout.split("WF_CALLS ")[1].split()[0]) > 0
    for suf in (".utg.final.gfa", ".annot_mito.txt", ".mito.ctg.fasta"):
        assert (tmp_path / f"asm{suf}").stat().st_size > 0


def test_no_jax_import_in_sources():
    """No source line of the port imports jax or the JAX package."""
    bad = []
    for p in (REPO / "oatk_tpu_torch").rglob("*.py"):
        for i, line in enumerate(p.read_text().splitlines(), 1):
            s = line.strip()
            if s.startswith(("import jax", "from jax", "import oatk_tpu.", "from oatk_tpu ",
                             "from oatk_tpu.", "import oatk_tpu ")) or s == "import oatk_tpu":
                bad.append(f"{p}:{i}: {s}")
    assert not bad, bad
