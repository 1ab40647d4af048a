from fem_tpu_torch.io.fastx import FastxRecord, read_fasta, stream_fastq_batches
from fem_tpu_torch.io.sam import sam_header_text

__all__ = [
    "FastxRecord",
    "read_fasta",
    "stream_fastq_batches",
    "sam_header_text",
]
