"""Port copy of platanus_b_tpu/io: FASTA/FASTQ ingest and read batches."""
