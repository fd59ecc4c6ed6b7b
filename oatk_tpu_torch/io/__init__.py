from .fastx import FastxReader, read_fastx, write_fasta
