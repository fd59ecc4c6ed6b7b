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


def _code_strings(path: pathlib.Path):
    """(line, value) of every string constant of a Python source that is
    code: docstrings and the values of ``"replaces"`` keys (the kernels
    line names the TPU kernel each CUDA kernel replaces) are left out."""
    import ast

    tree = ast.parse(path.read_text())
    skip = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant):
            skip.add(id(body[0].value))
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "replaces":
                    skip.add(id(v))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in skip:
            yield node.lineno, node.value


def test_no_path_into_jax_package():
    """No source of the port and no line of chip_smoke.py builds a path
    into the JAX package's tree: no string of code has ``oatk_tpu`` as a
    path component (comments, docstrings and the kernels line's
    ``replaces`` strings may name the TPU kernels' files)."""
    srcs = sorted((REPO / "oatk_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = []
    for p in srcs:
        for line, s in _code_strings(p):
            if "oatk_tpu" in s.replace("\\", "/").split("/"):
                bad.append(f"{p.relative_to(REPO)}:{line}: {s!r}")
    assert not bad, bad


def test_path_check_sees_a_path_into_jax_package(tmp_path):
    """The check above finds both spellings of such a path."""
    p = tmp_path / "m.py"
    p.write_text('"""doc: oatk_tpu/native"""\nimport os\n'
                 'a = os.path.join(R, "oatk_tpu", "native")\nb = f"{R}/oatk_tpu/native/x.c"\n'
                 'k = {"replaces": "oatk_tpu/kernels/x.py:1"}\n')
    hits = [line for line, s in _code_strings(p) if "oatk_tpu" in s.split("/")]
    assert hits == [3, 4]


def test_native_sources_match_jax_package():
    """The port builds its native library from its own copies of the C
    sources; each equals its twin in the JAX package byte for byte, so
    the two libraries cannot drift apart unnoticed.  The one difference
    allowed: a citation of the upstream C sources names them relative to
    the reference tree (``reference/x.c``), without the absolute
    directory the twin's comment carries."""
    import re

    import oatk_tpu_torch.native as N

    mine = sorted(pathlib.Path(s) for s in N._SRCS)
    assert mine and all(p.parent == REPO / "oatk_tpu_torch" / "native" for p in mine)
    assert sorted(p.name for p in mine) == sorted(
        p.name for p in (REPO / "oatk_tpu_torch" / "native").glob("*.c"))
    for p in mine:
        twin = REPO / "oatk_tpu" / "native" / p.name
        assert p.read_bytes() == re.sub(rb"/\w+/reference/", b"reference/", twin.read_bytes()), p.name
