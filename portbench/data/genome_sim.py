"""``random_genome`` of the repository's simulator (``tests/genome_sim.py``),
frozen here so that the benchmark's genomes do not move when the tests'
copy does.  Seeded output is deterministic per numpy version."""
from __future__ import annotations

import numpy as np

_NT = np.frombuffer(b"ACGT", np.uint8)


def random_genome(rng, length: int, hp_prob: float = 0.15, max_hp: int = 8) -> str:
    """Random circular genome with homopolymer runs (each emitted base
    extends into a run of 1+integers(1, max_hp) with prob hp_prob)."""
    parts = []
    have = 0
    while have < length:
        n = max(1024, int((length - have) / (1 + hp_prob * max_hp / 2)) + 16)
        codes = rng.integers(0, 4, size=n).astype(np.uint8)
        hp = rng.random(n) < hp_prob
        ext = rng.integers(1, max_hp, size=n)
        rep = 1 + np.where(hp, ext, 0)
        chunk = np.repeat(_NT[codes], rep)
        parts.append(chunk)
        have += len(chunk)
    return np.concatenate(parts)[:length].tobytes().decode()
