"""Host-side IO: FASTA/FASTQ/BAM readers feeding the device pipelines, and
the SAM writer (the port's copies of ``mgl_tpu/io``)."""

from mgl_tpu_torch.io.fasta import read_fasta, read_fastq  # noqa: F401
from mgl_tpu_torch.io.bam import read_bam  # noqa: F401
