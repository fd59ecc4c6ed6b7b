"""Host-side FASTA/FASTQ(.gz) streaming into numpy byte arrays.

Replaces the reference's kseq.h/sstream.c/kopen.c stack
(reference sstream.c:39-102).  Reads are surfaced as raw uint8
numpy arrays of ASCII bytes; downstream device kernels consume padded
batches built by :mod:`oatk_tpu.kernels.syncmer`.

Multi-file input is supported with globally increasing sequence ids,
matching sstream semantics.
"""
from __future__ import annotations

import gzip
import io
import sys
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np


@dataclass
class SeqRecord:
    sid: int
    name: str
    seq: np.ndarray  # uint8 ASCII bytes

    def __len__(self) -> int:
        return len(self.seq)


class _Prefixed(io.RawIOBase):
    """Raw stream replaying a consumed prefix before the wrapped stream
    (lets the gzip magic be read exactly even on pipes/sockets where
    peek() may return fewer bytes than asked)."""

    def __init__(self, prefix: bytes, fp):
        self._p = prefix
        self._fp = fp

    def readable(self):
        return True

    def readinto(self, b):
        if self._p:
            n = min(len(b), len(self._p))
            b[:n] = self._p[:n]
            self._p = self._p[n:]
            return n
        data = self._fp.read(len(b))
        if not data:
            return 0
        b[: len(data)] = data
        return len(data)

    def close(self):
        try:
            self._fp.close()
        finally:
            super().close()


def _open_maybe_gz(path: str):
    """Transparent open: plain file, gzip, stdin ('-'), remote
    http(s)/ftp URL, or a '<cmd' pipe (the command's stdout becomes the
    stream) -- the kopen.c analogue (reference kopen.c:259-320).
    gzip is sniffed from the magic bytes on every source kind."""
    if path == "-":
        fp = sys.stdin.buffer
    elif path.lstrip().startswith("<"):
        # pipe open: run the command, read its stdout
        # (reference kopen.c:286-311; shell only when the command
        # contains shell punctuation, mirroring its need_shell check)
        import subprocess

        cmd = path.lstrip()[1:]
        need_shell = any(
            not (c.isalnum() or c.isspace() or c in "._-:")
            for c in cmd
        )
        proc = subprocess.Popen(
            cmd if need_shell else cmd.split(),
            shell=need_shell,
            stdout=subprocess.PIPE,
        )
        fp = proc.stdout
    elif path.startswith(("http://", "https://", "ftp://")):
        import urllib.request

        fp = urllib.request.urlopen(path)  # noqa: S310 - explicit user input
    else:
        fp = open(path, "rb")
    # read exactly 2 magic bytes (peek() may return short on pipes),
    # then replay them through a prefixed stream
    magic = b""
    while len(magic) < 2:
        chunk = fp.read(2 - len(magic))
        if not chunk:
            break
        magic += chunk
    chained = io.BufferedReader(_Prefixed(magic, fp), 1 << 20)
    if magic == b"\x1f\x8b":
        return gzip.open(chained, "rb")
    return chained


def read_source_bytes(path: str) -> bytes:
    """Entire (decompressed) contents of any supported source; used by
    the fused native parse path.

    Plain uncompressed local files return a read-only ``mmap`` (a
    bytes-like the native bindings consume zero-copy): instead of a
    serial whole-file read on the critical path, pages fault in on
    demand inside the parallel parse workers, with ``MADV_WILLNEED``
    starting kernel readahead up front."""
    if path != "-" and not path.lstrip().startswith("<") and not path.startswith(
        ("http://", "https://", "ftp://")
    ):
        with open(path, "rb") as f:
            magic = f.read(2)
            if magic == b"\x1f\x8b":
                return gzip.decompress(magic + f.read())
            try:
                import mmap as _mmap

                mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
                try:
                    mm.madvise(_mmap.MADV_WILLNEED)
                except (AttributeError, OSError):
                    pass
                return mm  # type: ignore[return-value]
            except (ValueError, OSError):
                # empty file, or a non-mmapable local path (named pipe,
                # /dev/stdin): fall back to a plain stream read -- the
                # consumed magic probe is prepended, no seek needed
                return magic + f.read()
    with _open_maybe_gz(path) as fp:
        return fp.read()


def _iter_fastx(fp, sid0: int) -> Iterator[SeqRecord]:
    """Parse a FASTA or FASTQ stream (auto-detected per record)."""
    sid = sid0
    name = None
    chunks: list[bytes] = []
    line_iter = iter(fp)
    for raw in line_iter:
        line = raw.rstrip(b"\r\n")
        if not line:
            continue
        c = line[:1]
        if c == b">":
            if name is not None:
                yield SeqRecord(sid, name, np.frombuffer(b"".join(chunks), dtype=np.uint8))
                sid += 1
            name = line[1:].split()[0].decode() if len(line) > 1 else ""
            chunks = []
        elif c == b"@" and name is None:
            # FASTQ record: header, seq, +, qual
            fq_name = line[1:].split()[0].decode() if len(line) > 1 else ""
            seq_line = next(line_iter).rstrip(b"\r\n")
            next(line_iter)  # +
            qual = next(line_iter).rstrip(b"\r\n")
            while len(qual) < len(seq_line):  # multi-line qual (rare)
                qual += next(line_iter).rstrip(b"\r\n")
            yield SeqRecord(sid, fq_name, np.frombuffer(seq_line, dtype=np.uint8))
            sid += 1
        else:
            if name is None:
                raise ValueError("malformed FASTA/FASTQ input")
            chunks.append(line)
    if name is not None:
        yield SeqRecord(sid, name, np.frombuffer(b"".join(chunks), dtype=np.uint8))


class FastxReader:
    """Stream records from multiple FASTA/FASTQ(.gz) files with global sids."""

    def __init__(self, paths: Sequence[str]):
        self.paths = list(paths)
        self.n_seq = 0

    def __iter__(self) -> Iterator[SeqRecord]:
        sid = 0
        for path in self.paths:
            fp = _open_maybe_gz(path)
            try:
                for rec in _iter_fastx(fp, sid):
                    sid = rec.sid + 1
                    self.n_seq = sid
                    yield rec
            finally:
                if fp is not sys.stdin.buffer:
                    fp.close()


def read_fastx(paths: Sequence[str], max_data: int = 0) -> list[SeqRecord]:
    """Read all records; stop after ``max_data`` total bases if non-zero.

    Mirrors the ``-D`` data limit of the reference
    (reference syncmer.c:522-542).
    """
    out: list[SeqRecord] = []
    total = 0
    for rec in FastxReader(paths):
        out.append(rec)
        total += len(rec)
        if max_data and total >= max_data:
            break
    return out


def write_fasta(fp, name: str, seq: str, line_wd: int = 60, comment: str = "") -> None:
    if comment:
        fp.write(f">{name}\t{comment}\n")
    else:
        fp.write(f">{name}\n")
    for i in range(0, len(seq), line_wd):
        fp.write(seq[i : i + line_wd])
        fp.write("\n")
