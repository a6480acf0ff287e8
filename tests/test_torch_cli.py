"""The port's IO copies and its ``mgl-map`` CLI against the JAX package on
the CPU.

What is held:
- ``mgl_tpu_torch.io`` reads FASTA, FASTQ (plain and gzipped) and BAM as
  ``mgl_tpu.io`` does;
- ``python -m mgl_tpu_torch.cli ... --device cpu`` writes the same SAM
  bytes as ``mgl_tpu.cli.map_main`` on a small synthetic FASTA / FASTQ
  (``testing.write_map_inputs``) of uniform read length in both modes
  (score: ``align_and_sort``; ``--cigar``: the CIGAR stream, the JAX side
  under the Pallas interpreter), and on a mixed-length input, whose reads
  both cut or zero-pad to the modal length;
- the CLI, run as ``python -m``, imports nothing of jax or ``mgl_tpu``.
"""

import gzip
import os
import pathlib
import re
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from mgl_tpu_torch import cli
from mgl_tpu_torch.io import bam as P_bam
from mgl_tpu_torch.io import fasta as P_fasta
from mgl_tpu_torch.testing import write_map_inputs

ROOT = pathlib.Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX package's device path on the CPU: Pallas under the
    interpreter, launches padded to one lane tile."""
    import mgl_tpu.batch.bucketing as bucketing

    monkeypatch.setenv("MGL_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(bucketing, "bucket_dims", lambda n, grid=None: n)


def write_bam(path, n_records: int) -> None:
    """A small gzip-wrapped BAM: two references, records of 7-21 bases
    with three-op CIGARs (tests/test_io_packed.py's writer, varied)."""
    codes = "=ACMGRSVTWYHKDBN"
    text = "@HD\tVN:1.6\n"
    body = bytearray(b"BAM\x01" + struct.pack("<i", len(text))
                     + text.encode() + struct.pack("<i", 2))
    for name, ln in (("chr1", 1000), ("chrM", 16569)):
        body += (struct.pack("<i", len(name) + 1) + name.encode() + b"\x00"
                 + struct.pack("<i", ln))
    rng = np.random.default_rng(3)
    for k in range(n_records):
        l_seq = 7 + k % 15
        seq = "".join(rng.choice(list("ACGTN"), l_seq))
        packed = bytearray()
        for i in range(0, l_seq, 2):
            lo = codes.index(seq[i + 1]) if i + 1 < l_seq else 0
            packed.append((codes.index(seq[i]) << 4) | lo)
        name = f"q{k}".encode() + b"\x00"
        ops = [(2, 4), (l_seq - 3, 0), (1, 1)]          # 2S (l-3)M 1I
        rec = struct.pack("<iiBBHHHiiii", k % 2, 10 * k, len(name), k % 61,
                          0, len(ops), 16 * (k % 2), l_seq, -1, -1, 0)
        rec += name + b"".join(struct.pack("<I", (n << 4) | op)
                               for n, op in ops)
        rec += bytes(packed) + rng.integers(0, 42, l_seq).astype(
            np.uint8).tobytes()
        body += struct.pack("<i", len(rec)) + rec
    with gzip.open(path, "wb") as f:
        f.write(bytes(body))


def test_fasta_fastq_read_as_jax(tmp_path):
    """read_fasta and read_fastq (plain and .gz, max_reads) give the JAX
    package's names, bases and qualities."""
    from mgl_tpu.io import fasta as J_fasta

    fa, fq = write_map_inputs(tmp_path, 1)
    for src in (fa, fq):
        gz = src.with_suffix(src.suffix + ".gz")
        gz.write_bytes(gzip.compress(src.read_bytes()))
    for path in (fa, fa.with_suffix(".fa.gz")):
        got, want = P_fasta.read_fasta(path), J_fasta.read_fasta(path)
        assert list(got) == list(want) == ["chrA", "chrB"]
        for k in want:
            assert got[k].dtype == np.uint8
            assert np.array_equal(got[k], want[k])
    for path in (fq, fq.with_suffix(".fq.gz")):
        for cap in (None, 7):
            got = list(P_fasta.read_fastq(path, max_reads=cap))
            want = list(J_fasta.read_fastq(path, max_reads=cap))
            assert len(got) == len(want) == (cap or 40)
            for (n1, b1, q1), (n2, b2, q2) in zip(got, want):
                assert n1 == n2 and np.array_equal(b1, b2)
                assert np.array_equal(q1, q2)


def test_bam_reads_as_jax(tmp_path):
    """read_bam and iter_bam give the JAX package's header and records
    (names, flags, positions, CIGARs, bases with N, qualities)."""
    from mgl_tpu.io import bam as J_bam

    path = tmp_path / "small.bam"
    write_bam(path, 50)
    for cap in (None, 9):
        (h1, r1), (h2, r2) = (P_bam.read_bam(path, max_reads=cap),
                              J_bam.read_bam(path, max_reads=cap))
        assert h1 == h2 and len(r1) == len(r2) == (cap or 50)
        for a, b in zip(r1, r2):
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(a[k], b[k]), k
    assert r1[3]["cigar"] == "2S7M1I"
    assert [h for h, _ in P_bam.iter_bam(path)][0] == h2


def run_both(monkeypatch, tmp: pathlib.Path, fa, fq, extra: list[str]):
    """(the port's SAM bytes, the JAX package's SAM bytes) of one CLI run
    each on the same inputs, the port's on device="cpu"."""
    import mgl_tpu.cli as J_cli

    ours, theirs = tmp / "port.sam", tmp / "jax.sam"
    cli.map_main([str(fa), str(fq), str(ours), *extra, "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["mgl-map", str(fa), str(fq),
                                      str(theirs), *extra])
    J_cli.map_main()
    return ours.read_bytes(), theirs.read_bytes()


@pytest.mark.parametrize("mode", ["score", "cigar"])
def test_cli_sam_equals_jax(mode, tmp_path, monkeypatch, jax_interpret,
                            capsys):
    """The same SAM bytes as mgl-map on uniform 100 bp reads over two
    contigs; in --cigar mode every mapped record has a CIGAR, with D and I
    where the reads carry them, and no read was cut or padded."""
    fa, fq = write_map_inputs(tmp_path, 2)
    extra = ["--cigar"] if mode == "cigar" else []
    ours, theirs = run_both(monkeypatch, tmp_path, fa, fq, extra)
    assert ours == theirs
    out = capsys.readouterr().out
    assert "0 reads cut to it, 0 zero-padded to it" in out
    body = [ln.split("\t") for ln in ours.decode().splitlines()
            if not ln.startswith("@")]
    assert len(body) == 40
    mapped = [f for f in body if not int(f[1]) & 0x4]
    assert len(mapped) >= 30
    cigars = [f[5] for f in mapped]
    if mode == "cigar":
        assert "*" not in cigars
        assert any("D" in c for c in cigars) and any("I" in c for c in cigars)
        for c in cigars:
            assert sum(int(n) for n, op in re.findall(r"(\d+)([MIS])",
                                                      c)) == 100


def test_cli_mixed_lengths_kept_as_jax(tmp_path, monkeypatch, capsys):
    """On reads of 90-110 bp the modal length (100) wins, longer reads are
    cut and shorter ones zero-padded, as in mgl-map: the same SAM bytes,
    and the counts of both are printed."""
    lens = [100] * 26 + [90, 95, 99, 110, 101, 120, 100, 100, 97, 105, 100,
                         100, 100, 80]
    fa, fq = write_map_inputs(tmp_path, 3, lens)
    ours, theirs = run_both(monkeypatch, tmp_path, fa, fq, [])
    assert ours == theirs
    out = capsys.readouterr().out
    assert "4 reads cut to it, 5 zero-padded to it" in out


def test_cli_module_never_imports_jax(tmp_path):
    """python -m mgl_tpu_torch.cli --cigar --device cpu, run in a fresh
    interpreter, writes a SAM and leaves jax and every mgl_tpu module out
    of sys.modules."""
    fa, fq = write_map_inputs(tmp_path, 4)
    sam = tmp_path / "out.sam"
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['mgl-map-torch', {str(fa)!r}, {str(fq)!r}, "
        f"{str(sam)!r}, '--cigar', '--device', 'cpu']\n"
        "runpy.run_module('mgl_tpu_torch.cli', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'mgl_tpu')"
        " or m.startswith(('jax.', 'mgl_tpu.')))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env={**os.environ, "PYTHONPATH": str(ROOT),
                               "OMP_NUM_THREADS": "1"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "wrote 40 records" in proc.stdout
    assert sam.read_text().startswith("@HD\tVN:1.6\tSO:coordinate\n")
